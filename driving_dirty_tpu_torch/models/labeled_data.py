"""Labeled-dataset plumbing shared by the roadmap and box tasks
(driving_dirty_tpu/models/labeled_data.py): labeled scenes 106-133, a
scene-level 80/20 split, annotation.csv from the data root, the optional
decode-once sample cache (`cache_dir`, data/cache.py), and the labeled
tasks' data flags (`add_labeled_data_args`).
"""
from __future__ import annotations

import os

from driving_dirty_tpu_torch.data.cache import SampleCache
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
        link = hp(h, "link", None)
        annotation = hp(h, "annotation_file", None) or f"{link}/annotation.csv"
        sps = hp(h, "samples_per_scene", NUM_SAMPLE_PER_SCENE)
        n_scenes = hp(h, "num_labeled_scenes", len(LABELED_SCENES))
        train_idx, val_idx = scene_split(LABELED_SCENES[:n_scenes], seed=hp(h, "seed", 20200505))
        cache_dir = hp(h, "cache_dir", None)

        def mk(idx):
            ds = LabeledDataset(link, annotation, idx, max_boxes=hp(h, "max_bb", 100),
                                extra_info=extra_info, samples_per_scene=sps,
                                raw_uint8=bool(hp(h, "uint8_pipeline", True)))
            return SampleCache(ds, cache_dir) if cache_dir else ds

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


def add_labeled_data_args(parser):
    parser.add_argument("--link", type=str, default="/scratch/ab8690/DLSP20Dataset/data")
    parser.add_argument("--pretrained_path", type=str, default=None)
    parser.add_argument("--output_img_freq", type=int, default=500)
    parser.add_argument("--samples_per_scene", type=int, default=NUM_SAMPLE_PER_SCENE)
    parser.add_argument("--num_labeled_scenes", type=int, default=len(LABELED_SCENES))
    parser.add_argument("--cache_dir", type=str, default=None,
                        help="decode-once sample cache directory (data/cache.py): "
                             "epoch 2+ reads memmapped device-ready items instead "
                             "of re-decoding JPEG/PNG/CSV; shared across tasks")
    return parser
