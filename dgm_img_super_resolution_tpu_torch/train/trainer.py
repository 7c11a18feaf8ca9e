"""The trainer (counterpart of the JAX package's
``train/trainer.py``; the loop the reference config's keys describe,
``srdiff/config.yaml:1,15,21,33,35,76-79``).

The optimizer is optax's ``chain(clip_by_global_norm(clip_grad_norm),
adam(step decay))`` under ``MultiSteps(accumulate_grad_batches)``, written
over ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
root, as optax's):

- the clip scales every gradient by max_norm / ||g|| when the global norm
  ||g|| is at least max_norm, (g / ||g||) * max_norm as optax's (not
  ``clip_grad_norm_``'s max_norm / (||g|| + 1e-6));
- the learning rate is ``lr * 0.5 ** (updates // decay_steps)``, optax's
  ``exponential_decay(staircase=True)`` counted in applied updates;
- with k = ``accumulate_grad_batches`` > 1 the gradients of k micro-batches
  are averaged (optax's running mean acc + (g - acc) / (n + 1)) and clipped
  and applied as one update; Adam's count and the schedule advance once an
  update, while ``TrainState.step`` and the checkpoint names count
  micro-batches;
- EMA (``ema_decay`` > 0) moves at every micro-step, as JAX's ``_step``
  does when MultiSteps holds the update back.

On the card at world 1 a step replays captured CUDA graphs
(``Trainer.compile_step``, JAX's jitted ``compile_step``): Adam is
``capturable`` there, its rate a device tensor written from ``lr_at``
before each update and its count a device tensor, and the gradients go
through the optimizer's static buffers. Several ranks step eagerly: gloo's
collectives run through the host.

Parameters and Adam's moments stay float32; the model runs its activations
in ``compute_dtype`` (every layer casts its float32 weights to its input's
dtype, as flax's ``param_dtype`` float32 / ``dtype`` split). Rows 1-3 of the
kernel table launch in each forward under grad; their backward recomputes
their plain versions (``ops/kernels/_autograd.py``).

Data parallelism (``parallel/mesh.py``): one process a card, under
``torchrun``. The state is broadcast from rank 0 at ``init_state``;
``train_step`` takes the global batch, as JAX's, and runs this rank's rows
of it (a loader given the mesh yields those rows alone, as a ``Shard``),
drawing through a ``utils/draws.py:RowDraws`` over its generator; after
each micro-batch's backward one ``all_reduce`` averages the gradients and
the metrics, so that the clip, Adam, the schedule and the EMA agree on
every rank with no broadcast. Rank 0 alone writes the checkpoints, the JSON
log, TensorBoard and the code snapshot, and prints; every rank waits for
each save. ``fit`` resumes every rank from rank 0's newest checkpoint,
which rank 0 reads and broadcasts (``load_latest``), so a work dir local to
each host does not split the ranks. In a world of 1 all of it is the
identity.

Spatial sharding (``train_step(..., spatial=True)`` on a mesh with ``sp``
> 1, JAX's ``compile_step(batch_sharding=P("dp", "sp"))``): the batch rows
split over ``dp`` and every batch leaf's image rows over the rank's ``sp``
sub-group, each at its own resolution (HR, and LR at H / ``sr_scale``);
the loss runs under ``parallel.mesh.row_split`` (the convs' halo rows and
the norms' sums over the sub-group, forward and backward) and draws the
whole image's noise and keeps its rows. Rows split evenly, so the world
mean of the ranks' losses and gradients is the global batch's, and the
one all-reduce above needs nothing more. The step runs under
``kernels_disabled()``, the plain versions of the regions: a kernel pads a
shard's edges as the image's. JAX's GSPMD gathers the image around its
opaque Pallas calls there instead; the values are the same. Without
``spatial``, a mesh with ``sp`` > 1 trains as JAX's ``train_step`` does:
the batch over ``dp``, replicated over ``sp`` (``fit`` and ``dgmsr-torch
train`` train so).

Batches are the loader's NHWC numpy trees; ``batch_to_device`` copies them
through pinned memory without waiting and hands the model NCHW tensors in
channels_last memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import time
from typing import Callable, Iterable

import torch
import torch.nn as nn

from dgm_img_super_resolution_tpu_torch.ckpt.ckpt_io import load_checkpoint, save_checkpoint
from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.parallel.mesh import (
    Mesh,
    Shard,
    all_reduce_mean,
    barrier,
    batch_rows,
    broadcast_object,
    even_rows,
    is_main,
    make_mesh,
    replicate,
    row_split,
    shard_batch,
)
from dgm_img_super_resolution_tpu_torch.models.layers import kernels_disabled, routing_key
from dgm_img_super_resolution_tpu_torch.utils.draws import RowDraws
from dgm_img_super_resolution_tpu_torch.utils.misc import reduce_metrics, to_device
from dgm_img_super_resolution_tpu_torch.utils.profiling import trace_annotation


def lr_at(hp: Hparams, updates: int) -> float:
    """The learning rate of the update after ``updates`` applied ones: x0.5
    every ``decay_steps`` (JAX ``make_lr_schedule``)."""
    return float(hp["lr"]) * 0.5 ** (int(updates) // int(hp["decay_steps"]))


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax ``global_norm``)."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _rows_of(v, rows, image=None):
    """``rows`` of a tensor over the global batch (and with ``image`` =
    (index, size), that run of an NCHW tensor's image rows), of each in a
    tuple, or of what a noise hook returns."""
    if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == rows.total:
        v = rows.take(v)
        return v if image is None or v.ndim != 4 else even_rows(v.shape[2], *image).take(v, 2)
    if isinstance(v, (tuple, list)):
        return type(v)(_rows_of(u, rows, image) for u in v)
    if callable(v):
        return lambda *a: _rows_of(v(*a), rows, image)
    return v


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The loader's NHWC batch -> NCHW tensors on ``device`` in channels_last
    memory (through pinned memory on the card, without waiting)."""
    out = {}
    for k, v in to_device(batch, device).items():
        out[k] = v.permute(0, 3, 1, 2) if v.ndim == 4 else v
    return out


def make_adam(params, lr: float, betas: tuple[float, float], device: torch.device) -> torch.optim.Adam:
    """``torch.optim.Adam`` with eps 1e-8 outside the square root, as
    optax's. On the card it is ``capturable``, its rate a float32 device
    tensor (its ``param_groups``' ``lr``, written in place) and its count a
    device tensor, so that a step can be captured in a CUDA graph; on the
    CPU the rate is a float."""
    cap = torch.device(device).type == "cuda"
    rate = torch.full((), lr, dtype=torch.float32, device=device) if cap else lr
    return torch.optim.Adam(params, lr=rate, betas=betas, eps=1e-8, capturable=cap)


def set_rate(adam: torch.optim.Adam, lr: float) -> None:
    """Adam's rate for its next step: written into the device tensor of a
    capturable Adam (which a captured step reads), else set as a float."""
    for group in adam.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def adam_state_dict(adam: torch.optim.Adam) -> dict:
    """Adam's state dict with the rate as a float."""
    sd = adam.state_dict()
    for group in sd["param_groups"]:
        group["lr"] = float(group["lr"])
    return sd


def load_adam_state(adam: torch.optim.Adam, sd: dict) -> None:
    """Load an :func:`adam_state_dict` written on either device into an
    Adam of :func:`make_adam`: its own rate tensor (set to the saved rate)
    and capturable flag stay, and the counts go where they belong, the
    card when it is capturable, else the CPU."""
    keep = [(g["lr"], g["capturable"]) for g in adam.param_groups]
    adam.load_state_dict(sd)
    for group, (rate, cap) in zip(adam.param_groups, keep):
        group["capturable"] = cap
        if isinstance(rate, torch.Tensor):
            rate.fill_(float(group["lr"]))
            group["lr"] = rate
        else:
            group["lr"] = float(group["lr"])
    for p, st in adam.state.items():
        if "step" in st:
            cap = adam.param_groups[0]["capturable"]
            st["step"] = torch.as_tensor(st["step"], dtype=torch.float32).to(p.device if cap else "cpu")


class Optimizer:
    """``MultiSteps(chain(clip_by_global_norm, adam(schedule)), k)`` over
    ``params`` (JAX ``make_optimizer``). A micro-batch takes :meth:`begin`
    (whether its update is due), :meth:`accumulate` of its gradients (None
    for a parameter without one, which Adam leaves as it is, as optax's
    zero update does), :meth:`apply` when due and :meth:`end`: the pieces
    that a captured step replays.

    The gradients go through static buffers (``bufs``: the micro-batch's
    at k = 1, their running mean above), and on the card Adam is
    ``capturable``, its rate a device tensor written from ``lr_at`` before
    each update (:func:`set_rate`) and its count a device tensor, so that an
    update can be captured (``Trainer.compile_step``). On the CPU Adam takes
    the rate as a float. ``graphs`` holds the step's captured graphs, which
    read this optimizer's buffers and state: loading a state drops them."""

    def __init__(self, params: list[nn.Parameter], hp: Hparams):
        self.params = params
        self.hp = hp
        self.max_norm = float(hp["clip_grad_norm"] or 0.0)
        self.k = max(1, int(hp.get("accumulate_grad_batches", 1)))
        dev = params[0].device if params else torch.device("cpu")
        self.adam = make_adam(params, lr_at(hp, 0), (0.9, 0.999), dev)
        self.div_t = torch.ones((), dtype=torch.float32, device=dev)  # the running mean's n + 1
        self.bufs: list[torch.Tensor | None] | None = None
        self.updates = 0
        self.mini_step = 0
        self.graphs = graphs.GraphCache()

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return lr_at(self.hp, self.updates)

    def begin(self) -> bool:
        """Before a micro-batch: its n + 1 onto the device and, when it
        completes an update, the rate; whether it does."""
        due = self.mini_step + 1 == self.k
        if self.k > 1:
            self.div_t.fill_(self.mini_step + 1)
        if due:
            set_rate(self.adam, self.lr)
        return due

    def accumulate(self, grads: list[torch.Tensor | None]) -> None:
        """Fold one micro-batch's gradients into the buffers: a copy at
        k = 1, else optax's running mean acc + (g - acc) / (n + 1). The
        buffers are made at the first micro-batch, for the parameters that
        have a gradient there."""
        if self.bufs is None:
            self.bufs = [None if g is None else torch.zeros_like(g) for g in grads]
        pairs = [(b, g) for b, g in zip(self.bufs, grads) if b is not None and g is not None]
        if self.k == 1:
            torch._foreach_copy_([b for b, _ in pairs], [g for _, g in pairs])
            return
        for b, g in pairs:
            b.add_((g - b) / self.div_t)

    def apply(self) -> None:
        """Clip the buffers by their global norm and step Adam on them; at
        k > 1 zero them for the next mean."""
        present = [b for b in self.bufs if b is not None]
        if self.max_norm and present:
            norm = global_norm(present)
            keep = norm < self.max_norm
            torch._foreach_div_(present, torch.where(keep, torch.ones_like(norm), norm))
            torch._foreach_mul_(present, torch.where(keep, torch.ones_like(norm), torch.full_like(norm, self.max_norm)))
        for p, b in zip(self.params, self.bufs):
            p.grad = b
        self.adam.step()
        for p in self.params:
            p.grad = None
        if self.k > 1:
            torch._foreach_zero_(present)

    def end(self, due: bool) -> None:
        """The host's counts after a micro-batch."""
        if due:
            self.updates += 1
            self.mini_step = 0
        else:
            self.mini_step += 1

    def state_dict(self) -> dict:
        acc = self.bufs if self.k > 1 and self.mini_step else None
        return {"adam": adam_state_dict(self.adam), "updates": self.updates, "mini_step": self.mini_step,
                "acc_grads": acc}

    def load_state_dict(self, sd: dict) -> None:
        """Load a state of :meth:`state_dict`, written on either device."""
        self.graphs.clear()
        load_adam_state(self.adam, sd["adam"])
        self.updates, self.mini_step = int(sd["updates"]), int(sd["mini_step"])
        set_rate(self.adam, self.lr)
        acc = sd.get("acc_grads")
        self.bufs = None if acc is None else [None if a is None else a.to(p.device) for a, p in zip(acc, self.params)]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0  # micro-batches taken
    ema: dict[str, torch.Tensor] | None = None


class Trainer:
    """Single-optimizer trainer. ``loss_fn(model, batch, generator, **kw) ->
    (loss, metrics)`` over a batch on the device, which draws from
    ``generator`` through ``utils/draws.py``; ``init_params_fn(seed) ->
    nn.Module`` builds the initialised float32 model on the CPU. ``mesh``:
    ``make_mesh(hp['mesh_shape'])`` by default."""

    def __init__(self, hp: Hparams, loss_fn: Callable, init_params_fn: Callable[[int], nn.Module],
                 device: str | torch.device | None = None, work_dir: str | None = None,
                 mesh: Mesh | None = None):
        self.hp = hp
        self.loss_fn = loss_fn
        self.init_params_fn = init_params_fn
        self.mesh = mesh if mesh is not None else make_mesh(hp.get("mesh_shape", ""))
        self.device = resolve_device(device)
        self.work_dir = work_dir or hp["work_dir"]
        self.ema_decay = float(hp.get("ema_decay", 0.0))
        self._metrics_log: list[dict] = []
        self._tb = None  # the TBWriter, made when fit first logs
        self.loader_wait_s = 0.0  # fit's time waiting on the data iterator
        self.save_s: list[float] = []  # each checkpoint save's seconds

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int | None = None) -> TrainState:
        model = self.init_params_fn(int(self.hp["seed"]) if seed is None else seed).to(self.device)
        if self.device.type == "cuda":
            model.to(memory_format=torch.channels_last)  # conv weights NHWC, as the activations
        replicate(model, self.mesh)
        ema = None
        if self.ema_decay > 0:
            ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return TrainState(model, Optimizer(list(model.parameters()), self.hp), 0, ema)

    # ------------------------------------------------------------------ step
    def train_step(self, state: TrainState, batch: dict | Shard, generator: torch.Generator | None = None,
                   spatial: bool = False, **loss_kw) -> tuple[TrainState, dict]:
        """One micro-batch: loss and gradients, then the optimizer (which may
        hold the update back) and the EMA. ``batch`` is the loader's NHWC
        tree of the global batch, of which this rank runs its rows, or a
        ``Shard`` of those rows alone; ``spatial`` (a mesh with ``sp`` > 1)
        also splits every leaf's image rows over ``sp``. ``loss_kw`` goes
        to ``loss_fn`` (a test's ``t`` and ``noise``: a tensor, a tuple of
        them or a hook, over the global batch and the whole image, is
        sliced to the rows). Metrics are the global batch's, and stay on
        the device. On the card at world 1 the step replays its captured
        graphs (:meth:`compile_step`); over several ranks, whose gloo
        collectives run through the host, it runs eagerly."""
        if not spatial and self.mesh.world == 1 and graphs.enabled(self.device):
            return self.compile_step()(state, batch, generator, **loss_kw)
        return self._eager_step(state, batch, generator, spatial, **loss_kw)

    def compile_step(self) -> Callable:
        """The step as captured CUDA graphs, JAX's ``compile_step``
        (``train/trainer.py:138``): ``step(state, batch, generator=None,
        **loss_kw) -> (state, metrics)`` at world 1. Two graphs a
        micro-batch, each captured after its first, eager run
        (``core/graphs.py``) and kept on the optimizer: the micro-batch's
        (forward, backward through the regions' ``autograd.Function`` calls,
        the metrics, the gradients folded into the optimizer's buffers),
        then, chosen by the host's ``mini_step``, the update's (clip, Adam,
        then the EMA) or, while the update is held back, the EMA's: the
        EMA moves after the update, as in the eager step. The rate and the
        running mean's n + 1 are written to their device tensors before the
        replays. On the CPU and under ``graphs.eager()`` the same pieces run
        eagerly; a ``loss_kw`` that is not tensors (a noise hook) takes the
        eager step."""
        return self._compiled_step

    def _compiled_step(self, state: TrainState, batch: dict | Shard, generator: torch.Generator | None = None,
                       **loss_kw) -> tuple[TrainState, dict]:
        if self.mesh.world != 1:
            raise ValueError(f"a captured step runs one process; this one is rank {self.mesh.rank} of "
                             f"{self.mesh.world}: train_step runs it eagerly")
        loss_kw = {k: v for k, v in loss_kw.items() if v is not None}
        kw_in = graphs.tensor_inputs("kw", loss_kw)
        if kw_in is None or not graphs.enabled(self.device):
            return self._eager_step(state, batch, generator, False, **loss_kw)
        batch = batch_to_device(batch.data if isinstance(batch, Shard) else batch, self.device)
        opt = state.optimizer
        due = opt.begin()

        def micro(inputs, g):
            return self._micro(state, graphs.rebuild("batch", batch, inputs), g, graphs.rebuild("kw", loss_kw, inputs))

        key = ("micro", graphs.signature(batch), graphs.signature(loss_kw), routing_key())
        metrics = opt.graphs.run(key, micro, {**graphs.tensor_inputs("batch", batch), **kw_in}, generator)
        if due or state.ema is not None:
            opt.graphs.run(("update" if due else "ema",), lambda inputs, g: self._tail(state, due), {})
        opt.end(due)
        state.step += 1
        return state, metrics

    def _eager_step(self, state: TrainState, batch: dict | Shard, generator: torch.Generator | None,
                    spatial: bool, **loss_kw) -> tuple[TrainState, dict]:
        if isinstance(batch, Shard):
            rows, batch = batch.rows, batch.data
        else:
            rows = batch_rows(int(next(iter(batch.values())).shape[0]), self.mesh)
            batch = shard_batch(batch, self.mesh)
        image = None
        if spatial:
            if self.mesh.sp < 2:
                raise ValueError(f"a spatial step needs a mesh with sp > 1, not {self.mesh.shape}")
            image = (self.mesh.sp_rank, self.mesh.sp)  # each NHWC leaf's rows, at its own resolution
            batch = {k: even_rows(v.shape[1], *image).take(v, 1) if getattr(v, "ndim", 0) == 4 else v
                     for k, v in batch.items()}
        if rows.split or spatial:
            loss_kw = {k: _rows_of(v, rows, image) for k, v in loss_kw.items()}
            generator = RowDraws(generator, rows, image)
        batch = batch_to_device(batch, self.device)
        due = state.optimizer.begin()
        metrics = self._micro(state, batch, generator, loss_kw, spatial)
        self._tail(state, due)
        state.optimizer.end(due)
        state.step += 1
        return state, metrics

    def _micro(self, state: TrainState, batch: dict, generator, loss_kw: dict, spatial: bool = False) -> dict:
        """A micro-batch on the device: loss, gradients (averaged over the
        ranks with the metrics), the metrics, and the gradients folded into
        the optimizer's buffers."""
        params = state.optimizer.params
        with trace_annotation("loss_and_grad"), contextlib.ExitStack() as stack:
            if spatial:
                stack.enter_context(row_split(self.mesh, "sp"))
                stack.enter_context(kernels_disabled())
            loss, metrics = self.loss_fn(state.model, batch, generator, **loss_kw)
            loss.backward()
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        with trace_annotation("optimizer_update"):
            present = [g for g in grads if g is not None]
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            # one all_reduce: the gradients and the metrics, averaged over the ranks
            all_reduce_mean(present + list(metrics.values()), self.mesh)
            metrics["grad_norm"] = global_norm(present)
            if self.hp.get("print_nan_grads", False):
                # reference config key print_nan_grads (config.yaml:42): non-finite gradient elements
                metrics["nan_grads"] = sum((~torch.isfinite(g)).sum() for g in present)
            state.optimizer.accumulate(grads)
        return metrics

    def _tail(self, state: TrainState, due: bool) -> None:
        """The update when it is due, then the EMA, which moves at every
        micro-batch."""
        with trace_annotation("optimizer_update"):
            if due:
                state.optimizer.apply()
            if state.ema is not None:
                ema, d = list(state.ema.values()), self.ema_decay
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [p.detach() for p in state.model.parameters()], alpha=1.0 - d)

    # ------------------------------------------------------------------ loop
    def fit(self, data_iter: Iterable, generator: torch.Generator | int | None = None,
            max_updates: int | None = None, val_fn: Callable[[TrainState], dict] | None = None,
            log_every: int | None = None, resume: bool = True) -> TrainState:
        """Train until ``max_updates`` micro-batches; resume from the work
        dir's newest checkpoint (params, Adam, schedule, accumulation, EMA,
        step); validate and save every ``val_check_interval`` and on exit.
        ``generator`` (or a seed; ``hp['seed']`` by default) draws the
        steps' timesteps and noise on the device."""
        hp = self.hp
        max_updates = max_updates if max_updates is not None else hp["max_updates"]
        log_every = log_every or hp["tb_log_interval"]
        if not isinstance(generator, torch.Generator):
            seed = int(hp["seed"] if generator is None else generator)
            generator = torch.Generator(device=self.device).manual_seed(seed)
        main = is_main(self.mesh)
        if main:
            self._save_codes()
        state = self.init_state()
        start_step = 0
        if resume:
            ckpt, start_step = self.load_latest()
            if ckpt is not None:
                self.restore(state, ckpt)
                if main:
                    print(f"| resumed from step {start_step}")

        if val_fn is not None and int(hp.get("num_sanity_val_steps", 0)) > 0 and start_step == 0:
            # reference key num_sanity_val_steps (config.yaml:38): the validation path once before training
            sanity = reduce_metrics(val_fn(state), mesh=self.mesh)
            self._write_log({"step": 0, **{f"sanity_{k}": v for k, v in sanity.items()}})

        monitor_key = str(hp.get("valid_monitor_key", "val_loss")).removeprefix("val_")
        monitor_sign = -1.0 if hp.get("valid_monitor_mode", "min") == "min" else 1.0
        best = -float("inf")

        t0 = time.time()
        step = last_saved = start_step
        it = iter(data_iter)
        while step < max_updates:
            tw = time.perf_counter()
            batch = next(it, None)
            self.loader_wait_s += time.perf_counter() - tw
            if batch is None:
                break
            state, metrics = self.train_step(state, batch, generator)
            step = state.step
            if step % log_every == 0:
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars.update(step=step, sps=log_every / max(time.time() - t0, 1e-9))
                t0 = time.time()
                self._metrics_log.append(scalars)
                self._write_log(scalars)
                if main:
                    print("| " + json.dumps(scalars))
                    if scalars.get("nan_grads", 0):
                        print(f"| WARNING: {int(scalars['nan_grads'])} non-finite grad elements")
            if hp["val_check_interval"] and step % hp["val_check_interval"] == 0:
                if val_fn is not None:
                    val_metrics = reduce_metrics(val_fn(state), mesh=self.mesh)
                    self._write_log({"step": step, **{f"val_{k}": v for k, v in val_metrics.items()}})
                    score = monitor_sign * float(val_metrics.get(monitor_key, float("inf") * -monitor_sign))
                    if hp.get("save_best", False) and score > best:
                        # reference key save_best + valid_monitor_* (config.yaml:49,77-78)
                        best = score
                        self.save(state, step, subdir="best")
                self.save(state, step)
                last_saved = step
        # the final save on exit: without it a run off the validation cadence would lose its work
        if step > last_saved:
            self.save(state, step)
        return state

    def load_latest(self) -> tuple[dict | None, int]:
        """``(checkpoint, step)`` of rank 0's newest checkpoint in the work
        dir, on every rank (read by rank 0 and broadcast); ``(None, 0)``
        when there is none."""
        return broadcast_object(load_checkpoint(self.work_dir) if is_main(self.mesh) else None, self.mesh)

    def restore(self, state: TrainState, ckpt: dict) -> None:
        """Load a checkpoint of :meth:`save` into ``state``."""
        state.model.load_state_dict(ckpt["state_dict"]["model"])
        state.optimizer.load_state_dict(ckpt["optimizer_states"][0])
        state.step = int(ckpt["global_step"])
        if state.ema is not None:
            src = ckpt.get("ema") or dict(state.model.named_parameters())
            state.ema = {n: src[n].detach().to(p.device, copy=True) for n, p in state.model.named_parameters()}

    def save(self, state: TrainState, step: int, subdir: str = "") -> None:
        """``{global_step, state_dict: {model}, optimizer_states[, ema]}`` as
        ``model_ckpt_steps_<step>.ckpt``; ``num_ckpt_keep`` kept (1 under
        ``subdir``). Rank 0 writes; every rank returns once the file is
        there."""
        if not is_main(self.mesh):
            barrier(self.mesh)
            return
        t0 = time.perf_counter()
        payload = {"global_step": step, "state_dict": {"model": state.model.state_dict()},
                   "optimizer_states": [state.optimizer.state_dict()]}
        if state.ema is not None:
            payload["ema"] = state.ema
        work_dir = os.path.join(self.work_dir, subdir) if subdir else self.work_dir
        save_checkpoint(payload, work_dir, step, 1 if subdir else self.hp["num_ckpt_keep"])
        self.save_s.append(time.perf_counter() - t0)
        barrier(self.mesh)

    def _write_log(self, scalars: dict) -> None:
        """metrics.jsonl, and the same scalars as TensorBoard events
        (reference config.yaml:60 ``tb_log_interval``), by rank 0."""
        if not is_main(self.mesh):
            return
        os.makedirs(self.work_dir, exist_ok=True)
        with open(os.path.join(self.work_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(scalars) + "\n")
        if self._tb is None:
            from dgm_img_super_resolution_tpu_torch.utils.tbwriter import TBWriter

            self._tb = TBWriter(os.path.join(self.work_dir, "tb"))
        self._tb.add_scalars({k: v for k, v in scalars.items() if k != "step"}, int(scalars.get("step", 0)))

    def _save_codes(self) -> None:
        """Reference key ``save_codes`` (config.yaml:50-54): copy the listed
        source trees of this package into ``<work_dir>/codes``; missing
        entries are skipped."""
        entries = self.hp.get("save_codes") or []
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for name in entries:
            src = os.path.join(pkg_root, name)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(self.work_dir, "codes", name),
                                ignore=shutil.ignore_patterns("__pycache__", "*.so"), dirs_exist_ok=True)
