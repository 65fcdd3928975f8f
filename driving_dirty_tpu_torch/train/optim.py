"""Adam as the JAX trainer runs it, in optax's semantics rather than
torch.optim's (driving_dirty_tpu/train/trainer.py:217-237):

    optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    ... chain(optax.clip_by_global_norm(clip), optax.adam) when clip > 0
    ... inside optax.MultiSteps(every_k_schedule=k) when k > 1

Where the two libraries differ, this follows optax:

  * One global `count` (optax's ScaleByAdamState.count) sets the bias
    correction of every parameter. A parameter frozen for some epochs
    (requires_grad off, no gradient) stands for optax's exact-zero gradient:
    its moments stay zero and it does not move, so it is skipped, and when
    it unfreezes its first update uses bias correction t = count + 1, as in
    the JAX trainer (torch.optim.Adam counts per parameter and would use t = 1).
    A frozen parameter whose moments are not zero (it trained before) is
    updated with a zero gradient, as optax does.
  * Clipping is optax.clip_by_global_norm: the gradients are scaled by
    max_norm / g_norm only when g_norm >= max_norm (no epsilon; on the
    device, with no host sync).
  * Accumulation is optax.MultiSteps: a running (Welford) mean of the k
    micro-batch gradients, one Adam update (and count) every k micro-batches,
    clipping applied to the mean.
  * The moment weights are optax's: with plain Adam, inject_hyperparams
    holds b1 and b2 as f32 arrays, so 1 - b2 is taken in f32
    (1 - 0.999f = 0.00099998713); with clipping only the learning rate is
    injected and Adam's b1, b2 are Python floats, so 1 - b2 is taken in
    double and then rounded (0.001f), 1.3e-5 apart. eps is added outside
    the square root, eps_root (0) inside it.

The state round-trips through checkpoints/io.py:opt_state_leaves and
restore_opt_state as the JAX trainer's optax leaves.

Under a mesh (train/trainer.py) `reduce_grads` sums the gradients over the
data ranks once an update is due (every micro-batch, or the accumulated
mean at the window's end: the sum is linear; until then each data rank's
`acc` is its share, which the trainer sums for a checkpoint), and `tp` = (mesh, names of
the 'model'-sharded parameters) averages the replicated parameters'
gradients over 'model' after that sum (collectives.py:mean_over_model: the
ranks' copies get one gradient, so they stay equal where the card's
algorithms round differently on each rank) and makes the clipping norm
global: the shards' squared norms are summed over 'model', the replicated
leaves counted once. The moments and accumulators of a sharded parameter are its
shard's; which parameters' moments are nonzero is agreed over 'model'
when they are loaded, so every rank of a 'model' group takes the same
update path.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


class Adam:
    """optax Adam over the named parameters of a module (all of them,
    frozen or not, as optax holds state for every leaf)."""

    def __init__(self, named_params, lr: float, *, clip: float = 0.0, every_k: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 reduce_grads=None, tp=None):
        self.params = dict(named_params)
        self.reduce_grads, self.tp = reduce_grads, tp
        self.lr, self.b1, self.b2, self.eps, self.eps_root = lr, b1, b2, eps, eps_root
        self.clip = float(clip or 0.0)
        self.every_k = max(1, int(every_k))
        self.count = 0          # Adam updates so far (optax's count)
        self.mini_step = 0      # MultiSteps: micro-batches into the window
        self.gradient_step = 0  # MultiSteps: windows completed
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()} if self.every_k > 1 else {}
        # names whose moments (or accumulated gradient) may be nonzero
        self._moving: set = set()
        self._acc_moving: set = set()

    @torch.no_grad()
    def load_moments(self, mu=None, nu=None, acc=None):
        """Copy {name: tensor} moments (or accumulated gradients) in."""
        for dst, src in ((self.mu, mu), (self.nu, nu), (self.acc, acc)):
            for n, t in (src or {}).items():
                dst[n].copy_(t)
        self._moving = self._nonzero(self.params, lambda n: self.mu[n].any() | self.nu[n].any())
        self._acc_moving = self._nonzero(self.acc, lambda n: self.acc[n].any())

    def _nonzero(self, names, test) -> set:
        """The names whose `test` holds (on any rank of the 'model' group)."""
        names = sorted(names)
        if not names:
            return set()
        flags = torch.stack([test(n) for n in names]).to(torch.int32)
        if self.tp is not None:
            from driving_dirty_tpu_torch.parallel.collectives import summed

            flags = summed(flags, self.tp[0].tp_group)
        return {n for n, f in zip(names, flags.tolist()) if f}

    def _reduce(self, grads: dict):
        names = sorted(grads)  # the same order on every rank
        if self.reduce_grads is not None:
            self.reduce_grads([grads[n] for n in names])
        if self.tp is not None:
            from driving_dirty_tpu_torch.parallel.collectives import mean_over_model

            mesh, sharded = self.tp
            mean_over_model([grads[n] for n in names if n not in sharded], mesh)

    @torch.no_grad()
    def step(self) -> bool:
        """Take the parameters' .grad (None = frozen) as one micro-batch's
        gradient, clear it, and update as optax would. -> True when an Adam
        update was applied (every micro-batch, or every k-th under
        accumulation)."""
        grads = {n: p.grad for n, p in self.params.items() if p.grad is not None}
        for p in self.params.values():
            p.grad = None
        if self.every_k == 1:
            self._reduce(grads)
            self._adam(grads)
            return True
        mean = self._accumulate(grads)
        if mean is None:
            return False
        self._reduce(mean)
        self._adam(mean)
        for t in mean.values():  # the next window starts from zero
            t.zero_()
        self._acc_moving = set()
        return True

    def _accumulate(self, grads):
        """MultiSteps' running mean; -> {name: mean} (the accumulators) at
        the window's last micro-batch, else None."""
        names = sorted(set(grads) | self._acc_moving)
        if names:
            acc = [self.acc[n] for n in names]
            g = [grads[n] if n in grads else torch.zeros_like(self.acc[n]) for n in names]
            delta = torch._foreach_sub(g, acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(acc, delta)
            self._acc_moving |= set(names)
        emit = self.mini_step == self.every_k - 1
        self.mini_step = (self.mini_step + 1) % self.every_k
        if not emit:
            return None
        self.gradient_step += 1
        return {n: self.acc[n] for n in self._acc_moving}

    def _global_norm(self, names, g):
        norms = torch.stack(torch._foreach_norm(g))
        if self.tp is None:
            return torch.linalg.vector_norm(norms)
        from driving_dirty_tpu_torch.parallel.collectives import summed

        mesh, sharded = self.tp
        cut = torch.tensor([n in sharded for n in names], device=norms.device)
        sq = norms.square()
        return torch.sqrt(sq[~cut].sum() + summed(sq[cut].sum(), mesh.tp_group))

    def _one_minus(self, b: float) -> float:
        return _f32(1 - b) if self.clip else _f32(np.float32(1) - np.float32(b))

    def _adam(self, grads):
        names = sorted(set(grads) | self._moving)
        g = [grads[n] if n in grads else torch.zeros_like(self.params[n]) for n in names]
        if self.clip and g:
            g_norm = self._global_norm(names, g)
            keep = g_norm < self.clip
            one = torch.ones_like(g_norm)
            g = torch._foreach_div(g, torch.where(keep, one, g_norm))
            torch._foreach_mul_(g, torch.where(keep, one, torch.full_like(g_norm, self.clip)))
        self.count += 1
        t = np.float32(self.count)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1, bc2 = (float(np.float32(1) - b ** t) for b in (b1, b2))
        if not names:
            return
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        torch._foreach_mul_(mu, float(b1))
        torch._foreach_add_(mu, g, alpha=self._one_minus(self.b1))
        torch._foreach_mul_(nu, float(b2))
        torch._foreach_addcmul_(nu, g, g, value=self._one_minus(self.b2))
        denom = torch._foreach_div(nu, bc2)
        if self.eps_root:
            torch._foreach_add_(denom, _f32(self.eps_root))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _f32(self.eps))
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_mul_(update, -_f32(self.lr))
        torch._foreach_add_([self.params[n] for n in names], update)
        self._moving |= set(names)
