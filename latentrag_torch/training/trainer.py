"""The autoencoder trainer: Adam(W) behind a global-norm clip, early
stopping, the plateau schedule, checkpoints and resume.

The port of the JAX package's ``training/trainer.py``:

* one trainer for the three variants, the loss in fp32 (``losses.py``);
* Adam, or AdamW when ``weight_decay > 0`` (one parameter group, every
  tensor decayed, as optax decays every leaf), behind optax's global-norm
  clip (``clip_by_global_norm``: the grads are scaled by max_norm / norm
  only when norm >= max_norm);
* the ReduceLROnPlateau-style schedule scales the optimizer's
  ``param_groups[...]["lr"]``, where the JAX trainer scales the injected
  learning rate of its optax state;
* early stopping on an absolute (VAE, DAE) or relative (CAE) min-delta
  with patience;
* at each improvement the best state is copied (PyTorch parameters change
  in place, where JAX's are values) and written: the weights as the
  reference-keyed ``.pth`` that ``pipeline.load_autoencoder`` reads, and
  beside it ``<name>.train.pt`` with the model and optimizer state dicts,
  ``epoch`` and ``best_val``, from which ``resume`` continues (the shuffle
  stream restarts, as in JAX).

Batches come from ``np.random.default_rng(seed)``'s shuffle, so both
packages see the same batches. The VAE draws its noise from a
``torch.Generator`` on the device, seeded with ``seed`` for training and
re-seeded with ``seed + 1`` at each validation; JAX splits PRNG keys
instead, so the draws differ.

Data parallelism (``Trainer(..., mesh=parallel.make_mesh(...))``, the JAX
trainer's ``mesh=``): the parameters are replicated (the model on the
mesh's first device, a copy on each other distinct device) and each batch
is sharded over the mesh, and a step is the single-device step on the
GLOBAL batch:

* the batch size is rounded down to a multiple of the mesh size (to P
  when that leaves 0); a ragged batch (validation's tail, a tiny dataset)
  is not sharded and its loss is the whole batch's, on the first device;
* each shard runs the model's forward on its rows; the outputs are
  gathered in row order (``parallel.distributed.all_gather_cat_grad``
  across processes, the gradient flowing back through the gather) and the
  variant's loss is taken over the whole batch: the VAE's and the DAE's
  means, and the CAE's hard negatives mined over the global batch;
* the VAE's noise is one [B, latent] draw of the step's generator, split
  over the shards, so a mesh and one device train alike from one seed;
* the shards' gradients are summed onto the first device and across
  processes (an ``all_reduce``), so every replica takes the same update
  and the same early-stopping decision from the same global validation
  loss. Each process takes its rows of the same shuffled global batch;
  only process 0 writes the ``.pth`` and ``<ae>.train.pt`` (the others wait
  at a barrier), and ``resume`` reads them on every process.
"""

from __future__ import annotations

import copy
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..models.autoencoders import init_autoencoder
from ..utils.config import TrainingConfig
from ..utils.device import resolve_device
from .losses import contrastive_loss, dae_loss, vae_loss

log = logging.getLogger("latentrag_torch.train")


@dataclass
class TrainResult:
    params: dict  # the best state dict
    best_val_loss: float
    epochs_ran: int
    history: list = field(default_factory=list)  # (epoch, train, val)
    stopped_early: bool = False


# ---------------------------------------------------------------- optimizer


def make_optimizer(params, learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8), or ``adamw`` when
    ``weight_decay > 0``: one group, every tensor decayed."""
    params = list(params)
    if weight_decay and weight_decay > 0:
        return torch.optim.AdamW(params, lr=learning_rate,
                                 weight_decay=weight_decay, eps=1e-8)
    return torch.optim.Adam(params, lr=learning_rate, eps=1e-8)


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm``: each grad becomes
    ``g / norm * max_norm`` when the global norm >= ``max_norm``, else
    stays as it is (``clip_grad_norm_`` would divide by norm + 1e-6 and
    always scale). No host sync."""
    norm = torch.sqrt(sum(torch.sum(g.float().square()) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            for g in grads]


def apply_gradients(optimizer: torch.optim.Optimizer,
                    grads: Sequence[torch.Tensor],
                    clip_norm: float = 0.0) -> None:
    """One optimizer step from ``grads`` (one per parameter, in the
    optimizer's order): the global-norm clip when ``clip_norm > 0``, then
    Adam(W)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != len(grads):
        raise ValueError(f"{len(grads)} grads for {len(params)} parameters")
    if clip_norm and clip_norm > 0:
        grads = clip_by_global_norm(grads, clip_norm)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def grads_of(loss: torch.Tensor,
             params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not read
    (the CAE's decoder): JAX's grads hold zeros there, so AdamW still
    decays it."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def scale_lr(optimizer: torch.optim.Optimizer, factor: float) -> None:
    """The plateau schedule's step: every group's learning rate x factor."""
    for group in optimizer.param_groups:
        group["lr"] *= factor


# -------------------------------------------------------------- checkpoints


def snapshot(module: nn.Module) -> dict:
    """A copy of ``module``'s state dict that later steps do not change."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_weights(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """A state dict as host tensors in a ``.pth``, written atomically."""
    _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def training_state_path(weights_path: str) -> str:
    """The resume file beside an AE's weights: ``<name>.train.pt``."""
    return os.path.splitext(weights_path)[0] + ".train.pt"


def save_training_state(path: str, module: nn.Module,
                        optimizer: torch.optim.Optimizer, epoch: int,
                        best_val: float) -> None:
    """What a run needs to continue: the module's and the optimizer's
    state dicts (Adam's step count and moments), the epoch just finished
    and the best validation loss."""
    _atomic_save({
        "model": {k: v.detach().cpu() for k, v in module.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch), "best_val": float(best_val),
    }, path)


def restore_training_state(path: str, module: nn.Module,
                           optimizer: torch.optim.Optimizer
                           ) -> tuple[float, int]:
    """Load ``save_training_state``'s file into ``module`` and
    ``optimizer`` (on their devices); returns (best_val, start_epoch =
    epoch + 1)."""
    st = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(st["model"])
    optimizer.load_state_dict(st["optimizer"])
    return float(st["best_val"]), int(st["epoch"]) + 1


# ------------------------------------------------------------------ trainer


@dataclass
class ShardedBatch:
    """A global batch on a mesh: ``whole`` (every row, on the first
    device: the targets), and ``parts``, this process's rows split over
    its shards, ``parts[j]`` on ``mesh.devices[j]``."""

    whole: dict
    parts: list
    rows: int  # the global batch's rows


class Trainer:
    """Train one autoencoder variant on host numpy arrays, on ``device``
    (default CUDA; the CPU only when asked), or data-parallel over
    ``mesh`` (a ``parallel.Mesh``; its first device holds the model)."""

    def __init__(self, model: nn.Module, ae_type: str, cfg: TrainingConfig,
                 device="cuda", mesh=None):
        if ae_type not in ("vae", "dae", "cae"):
            raise ValueError(f"unknown ae_type {ae_type!r}")
        self.mesh = mesh
        self.device = resolve_device(mesh.devices[0] if mesh is not None
                                     else device)
        self.model = model.to(self.device)
        self.ae_type = ae_type
        self.cfg = cfg
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, cfg.learning_rate,
                                        cfg.weight_decay)
        # the replicas on the mesh's other devices, refreshed after a step
        self.replicas = {} if mesh is None else {
            d: copy.deepcopy(self.model).to(d)
            for d in mesh.distinct_devices() if d != self.device}

    # -- steps --------------------------------------------------------------

    def _outputs(self, module: nn.Module, batch: Mapping[str, torch.Tensor],
                 generator=None, eps=None) -> tuple:
        """The model's outputs on ``batch`` that the loss reads."""
        if self.ae_type == "vae":
            return module(batch["x"], train=True, generator=generator,
                          eps=eps)
        if self.ae_type == "dae":
            return (module(batch["x"]),)
        enc = module.encode
        # when mining in-batch hard negatives the dataset's negatives are
        # unused, so they are not encoded
        if "n" in batch and not self.cfg.mine_hard_negatives:
            return enc(batch["q"]), enc(batch["p"]), enc(batch["n"])
        return enc(batch["q"]), enc(batch["p"])

    def _loss_of(self, outs: tuple, batch: Mapping[str, torch.Tensor]
                 ) -> torch.Tensor:
        """The variant's fp32 loss over the whole batch's outputs."""
        cfg = self.cfg
        if self.ae_type == "vae":
            recon, mu, logvar = outs
            return vae_loss(recon, batch["y"], mu, logvar, beta=cfg.beta)[0]
        if self.ae_type == "dae":
            return dae_loss(outs[0], batch["y"])
        return contrastive_loss(outs[0], outs[1],
                                outs[2] if len(outs) > 2 else None,
                                margin=cfg.triplet_margin,
                                mine_hard_negatives=cfg.mine_hard_negatives)

    def _module_on(self, device) -> nn.Module:
        return self.model if device == self.device else self.replicas[device]

    def _sharded_outputs(self, sb: ShardedBatch, generator=None,
                         eps=None) -> tuple:
        """Each shard's outputs on its rows, gathered in global row order
        on the first device (across processes too, the gradient flowing
        back through the gather). The VAE's noise is one global draw, each
        shard taking its rows of it."""
        mesh = self.mesh
        if self.ae_type == "vae" and eps is None:
            if generator is None:
                raise ValueError("train=True needs a generator or eps")
            eps = torch.randn((sb.rows, self.model.latent_dim),
                              generator=generator, device=self.device)
        per = sb.rows // mesh.size
        local = []
        for j, part in enumerate(sb.parts):
            dev = mesh.devices[j]
            e = None
            if eps is not None:
                g = mesh.global_index(j)
                e = eps[g * per:(g + 1) * per].to(dev)
            local.append(self._outputs(self._module_on(dev), part, eps=e))
        outs = tuple(torch.cat([o[i].to(self.device) for o in local])
                     for i in range(len(local[0])))
        if mesh.world > 1:
            from ..parallel.distributed import all_gather_cat_grad

            outs = tuple(all_gather_cat_grad(o, mesh).to(self.device)
                         for o in outs)
        return outs

    def loss(self, batch, generator: torch.Generator | None = None,
             eps: torch.Tensor | None = None) -> torch.Tensor:
        """The variant's fp32 loss on one batch (a dict of tensors, or a
        mesh's ``ShardedBatch``: the global batch's loss); the VAE samples
        with ``eps`` when given, else from ``generator``."""
        if isinstance(batch, ShardedBatch):
            return self._loss_of(self._sharded_outputs(batch, generator, eps),
                                 batch.whole)
        return self._loss_of(self._outputs(self.model, batch, generator, eps),
                             batch)

    def train_step(self, batch, generator: torch.Generator | None = None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
        """One optimizer step; returns the batch's loss (on the device).
        The replicas take the updated parameters."""
        loss, grads = self.step_grads(batch, generator, eps)
        apply_gradients(self.optimizer, grads, self.cfg.grad_clip_norm)
        self._sync_replicas()
        return loss

    def step_grads(self, batch, generator: torch.Generator | None = None,
                   eps: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The batch's loss (detached) and the gradient a step applies, of
        the first device's parameters. On a mesh the shards' gradients are
        summed on the first device and across processes: the gradient of
        the global batch's loss."""
        loss = self.loss(batch, generator, eps)
        sharded = isinstance(batch, ShardedBatch)
        world = self.mesh.world if sharded else 1
        # across processes each computes the same global loss, and the
        # gather's backward sums every process's gradient of its rows
        target = loss / world if world > 1 else loss
        replicas = list(self.replicas.values()) if sharded else []
        params = self.params + [p for r in replicas for p in r.parameters()]
        grads = grads_of(target, params)
        n = len(self.params)
        for r in range(len(replicas)):
            part = grads[n * (r + 1):n * (r + 2)]
            grads[:n] = [g + x.to(self.device)
                         for g, x in zip(grads[:n], part)]
        grads = grads[:n]
        if world > 1:
            from ..parallel.distributed import all_reduce_sum

            grads = all_reduce_sum(grads, self.mesh)
        return loss.detach(), grads

    def _sync_replicas(self) -> None:
        """Copy the first device's parameters into every replica."""
        for rep_module in self.replicas.values():
            with torch.no_grad():
                for p_r, p in zip(rep_module.parameters(), self.params):
                    p_r.copy_(p)

    @torch.no_grad()
    def eval_step(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None) -> torch.Tensor:
        return self.loss(batch, generator)

    # -- data plumbing ------------------------------------------------------

    def _device_batch(self, arrays: Mapping[str, np.ndarray]):
        """A batch on the device; on a mesh a ``ShardedBatch`` when its
        rows divide over the shards, else (a ragged batch) the whole batch
        on the first device."""
        whole = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in arrays.items()}
        rows = len(next(iter(arrays.values())))
        if self.mesh is None or rows % self.mesh.size:
            return whole
        per = rows // self.mesh.size
        parts = []
        for j, dev in enumerate(self.mesh.devices):
            lo = self.mesh.global_index(j) * per
            parts.append({k: torch.from_numpy(np.ascontiguousarray(
                v[lo:lo + per])).to(dev) for k, v in arrays.items()})
        return ShardedBatch(whole, parts, rows)

    def _batches(self, data, batch_size, rng=None, drop_last=True):
        keys = list(data.keys())
        n = len(data[keys[0]])
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        if self.mesh is not None:
            # batches of a multiple of the mesh, so each shard gets rows
            p = self.mesh.size
            batch_size = batch_size - (batch_size % p) or p
        if drop_last and 0 < n < batch_size:
            # rather than an epoch of no step, one batch of every row
            log.warning(
                "batch_size %d > dataset size %d; using one %d-row batch",
                batch_size, n, n,
            )
            yield self._device_batch({k: data[k][idx] for k in keys})
            return
        end = n - (n % batch_size) if drop_last else n
        for start in range(0, end, batch_size):
            sel = idx[start:start + batch_size]
            yield self._device_batch({k: data[k][sel] for k in keys})

    # -- fitting ------------------------------------------------------------

    def fit(
        self,
        train_data: Mapping[str, np.ndarray],
        val_data: Mapping[str, np.ndarray],
        *,
        checkpoint_path: str | None = None,
        init_state: Mapping[str, torch.Tensor] | None = None,
        seed: int | None = None,
        resume: bool = False,
    ) -> TrainResult:
        """Train from ``init_state`` (else ``init_autoencoder`` seeded with
        ``seed``) with a fresh optimizer; with ``checkpoint_path`` (the
        ``.pth``) every improvement writes the weights and the resume
        state, and ``resume`` continues from that state when it is there.
        The best state is loaded back into the model at the end."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        shuffle_rng = np.random.default_rng(seed)
        if init_state is not None:
            self.model.load_state_dict(init_state)
        else:
            init_autoencoder(self.model, torch.Generator().manual_seed(seed))
        lead = self.mesh is None or self.mesh.rank == 0
        self.optimizer = make_optimizer(self.params, cfg.learning_rate,
                                        cfg.weight_decay)
        sampler = torch.Generator(device=self.device).manual_seed(seed)

        best_val = math.inf
        start_epoch = 0
        state_path = (training_state_path(checkpoint_path)
                      if checkpoint_path else None)
        if resume and state_path and os.path.isfile(state_path):
            best_val, start_epoch = restore_training_state(
                state_path, self.model, self.optimizer)
            log.info("[%s] resumed from %s at epoch %d (best val %.5f)",
                     self.ae_type, state_path, start_epoch, best_val)
        self._sync_replicas()
        best_state = snapshot(self.model)
        patience_left = cfg.early_stop_patience
        plateau_left = cfg.lr_plateau_patience
        history: list = []
        stopped = False
        epochs_ran = start_epoch

        for epoch in range(start_epoch, cfg.epochs):
            epochs_ran = epoch + 1
            self.model.train()
            losses = [self.train_step(batch, sampler) for batch in
                      self._batches(train_data, cfg.batch_size, shuffle_rng)]
            train_loss = (torch.stack(losses).mean().item() if losses
                          else float("nan"))
            # validation re-seeds its sampler: the same draws every epoch
            self.model.eval()
            vsampler = torch.Generator(device=self.device).manual_seed(
                seed + 1)
            vlosses = [self.eval_step(batch, vsampler) for batch in
                       self._batches(val_data, cfg.batch_size,
                                     drop_last=False)]
            val_loss = (torch.stack(vlosses).mean().item() if vlosses
                        else train_loss)
            history.append((epoch, train_loss, val_loss))
            log.info("[%s] epoch %d train %.5f val %.5f", self.ae_type,
                     epoch, train_loss, val_loss)

            if cfg.early_stop_relative:
                improved = val_loss < best_val * (1.0 - cfg.early_stop_min_delta)
            else:
                improved = val_loss < best_val - cfg.early_stop_min_delta
            if improved:
                best_val = val_loss
                best_state = snapshot(self.model)
                patience_left = cfg.early_stop_patience
                plateau_left = cfg.lr_plateau_patience
                if checkpoint_path:
                    if lead:  # process 0 writes; the others wait for it
                        save_weights(best_state, checkpoint_path)
                        save_training_state(state_path, self.model,
                                            self.optimizer, epoch, best_val)
                    if self.mesh is not None:
                        from ..parallel.distributed import barrier

                        barrier()
            else:
                patience_left -= 1
                plateau_left -= 1
                if cfg.lr_plateau_factor and plateau_left <= 0:
                    scale_lr(self.optimizer, cfg.lr_plateau_factor)
                    plateau_left = cfg.lr_plateau_patience
                if patience_left <= 0:
                    stopped = True
                    log.info("[%s] early stop at epoch %d", self.ae_type,
                             epoch)
                    break

        self.model.load_state_dict(best_state)
        self._sync_replicas()
        return TrainResult(params=best_state, best_val_loss=best_val,
                           epochs_ran=epochs_ran, history=history,
                           stopped_early=stopped)
