"""Labeled-dataset plumbing shared by the roadmap and box tasks
(driving_dirty_tpu/models/labeled_data.py:20-65): labeled scenes 106-133,
a scene-level 80/20 split, annotation.csv from the data root. The argparse
helpers come with the CLIs; the decode-once sample cache (`cache_dir`) is
not ported yet and raises.
"""
from __future__ import annotations

import os

from driving_dirty_tpu_torch.data.dataset import (
    LABELED_SCENES,
    NUM_SAMPLE_PER_SCENE,
    LabeledDataset,
    scene_split,
)
from driving_dirty_tpu_torch.data.pipeline import Loader
from driving_dirty_tpu_torch.train.task import hp


class LabeledDataMixin:
    def _labeled_datasets(self, extra_info=False):
        h = self.hparams
        if hp(h, "cache_dir", None):
            raise NotImplementedError("the decode-once sample cache (cache_dir) is not ported yet")
        link = hp(h, "link", None)
        annotation = hp(h, "annotation_file", None) or f"{link}/annotation.csv"
        sps = hp(h, "samples_per_scene", NUM_SAMPLE_PER_SCENE)
        n_scenes = hp(h, "num_labeled_scenes", len(LABELED_SCENES))
        train_idx, val_idx = scene_split(LABELED_SCENES[:n_scenes], seed=hp(h, "seed", 20200505))

        def mk(idx):
            return LabeledDataset(link, annotation, idx, max_boxes=hp(h, "max_bb", 100),
                                  extra_info=extra_info, samples_per_scene=sps,
                                  raw_uint8=bool(hp(h, "uint8_pipeline", True)))

        return mk(train_idx), mk(val_idx)

    def _num_workers(self):
        # the reference hardcodes 4; this scales with the host, capped
        return hp(self.hparams, "num_workers", None) or min(48, 4 * (os.cpu_count() or 4))

    def train_loader(self):
        tr, _ = self._labeled_datasets()
        return Loader(tr, self.batch_size, shuffle=True,
                      num_workers=self._num_workers(), drop_last=True)

    def val_loader(self):
        _, va = self._labeled_datasets()
        return Loader(va, self.batch_size, shuffle=False, num_workers=self._num_workers())
