"""K train steps as one CUDA graph, replayed with one host call.

Counterpart of the JAX package's K steps per dispatch: `jax.lax.scan` of
`_step` over K stacked index batches inside one jitted launch
(mocodad_tpu/training/loop.py:262-270, grouped by `_group_batches`,
:46-57).  On the card a group of K steps is captured once per `fit` as one
graph of K copies of `Trainer.update` (gather `pool[idx]`, the affine
views, the loss, the backward, capturable Adam and the EMA) and replayed
for every group of the fit, after the group's (K, B) index, view and mask
vectors and its draws have been copied into the graph's static inputs.

What a replay cannot do, and what stands in for it:
- Reseed the step's generator: each step's draws (the random_imp frame
  order, t and the forward noise) are made eagerly before the replay with
  the step-seeded generator, in the order `loss` draws them
  (`Trainer.step_draws`), into static (K, ...) inputs that `loss` takes
  as `order` and `noise_override`.  So a replayed group draws what K eager
  steps draw.
- Read a Python learning rate: Adam is `capturable`, with the staircase
  lr in a device tensor written before each dispatch.  Its bias
  correction is then computed on the device in float32, a rounding-level
  difference from the eager Adam's Python floats.
- Allocate the gradients: they are zeroed in place in every step.

Before the capture one warm-up step runs eagerly on a side stream, so
that Adam's state, the cuBLAS and cuDNN handles and the device tables
exist; every parameter, buffer, EMA tensor and Adam state tensor is
copied back in place after it (Adam state it created is zeroed, which is
what a fresh Adam holds), so the warm-up trains nothing.  Capture runs
with `capture_error_mode='thread_local'`: the loader's producer thread
may copy the next batches meanwhile.  A failed capture or replay raises;
nothing falls back to eager steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

Draws = Tuple[Optional[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# profiler range of one replay
REPLAY_SPAN = 'step_graph.replay'


class StepGraph:
    """`k` steps of `trainer.update` over `rows` windows each, gathered
    from `trainer.pool`, as one CUDA graph.  Captured when built."""

    def __init__(self, trainer, k: int, rows: int):
        self.trainer, self.k = trainer, k
        dev, model = trainer.device, trainer.model
        window = tuple(trainer.pool.shape[1:])
        self.idx = torch.zeros((k, rows), dtype=torch.int32, device=dev)
        self.trans = torch.zeros((k, rows), dtype=torch.int32, device=dev)
        self.mask = torch.ones((k, rows), device=dev)
        self.t = torch.ones((k, rows), dtype=torch.long, device=dev)
        self.eps = torch.zeros((k, rows) + model.noise_shape(window),
                               device=dev)
        self.order = None
        if model.draws_order:
            self.order = torch.arange(window[1], device=dev).repeat(
                k, rows, 1)
        self.idx.copy_(torch.arange(rows, device=dev).remainder(
            trainer.pool.shape[0]).expand(k, rows))
        self.names: List[str] = []
        self.metrics: Optional[torch.Tensor] = None   # (k, len(names))
        self.finite: Optional[torch.Tensor] = None    # (k,) under debug_nans
        self.replays = 0
        self.graph = torch.cuda.CUDAGraph()
        self._warm_up()
        self._capture()

    def _steps(self, n: int):
        tr = self.trainer
        return [tr.update(tr.pool.index_select(0, self.idx[j]),
                          self.trans[j], self.mask[j],
                          (self.t[j], self.eps[j]),
                          None if self.order is None else self.order[j])
                for j in range(n)]

    def _warm_up(self) -> None:
        tr = self.trainer
        before = tr.state_tensors()
        saved = [x.detach().clone() for x in before]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._steps(1)
        torch.cuda.current_stream().wait_stream(side)
        known = {id(x) for x in before}
        with torch.no_grad():
            for x, s in zip(before, saved):
                x.copy_(s)
            for x in tr.state_tensors():
                if id(x) not in known:
                    x.zero_()

    def _capture(self) -> None:
        with torch.cuda.graph(self.graph, capture_error_mode='thread_local'):
            outs = self._steps(self.k)
            self.names = list(outs[0][0])
            self.metrics = torch.stack(
                [torch.stack([m[n] for n in self.names]) for m, _ in outs])
            if outs[0][1] is not None:
                self.finite = torch.stack([f for _, f in outs])

    def replay(self, idx: torch.Tensor, trans: torch.Tensor,
               mask: torch.Tensor, draws: Sequence[Draws]
               ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """Run the group: (k, rows) indices, views and mask, and each
        step's draws, copied into the static inputs on the current stream
        (the replay's), then one replay.  Returns each metric's (k,)
        values and, under debug_nans, each step's finite flag, copied out
        of the graph's outputs."""
        self.idx.copy_(idx)
        self.trans.copy_(trans)
        self.mask.copy_(mask)
        for j, (order, (t, eps)) in enumerate(draws):
            self.t[j].copy_(t)
            self.eps[j].copy_(eps)
            if self.order is not None:
                self.order[j].copy_(order)
        with torch.profiler.record_function(REPLAY_SPAN):
            self.graph.replay()
        self.replays += 1
        out = self.metrics.clone()
        return ({n: out[:, i] for i, n in enumerate(self.names)},
                None if self.finite is None else self.finite.clone())
