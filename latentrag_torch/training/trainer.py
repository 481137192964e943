"""The autoencoder trainer: Adam(W) behind a global-norm clip, early
stopping, the plateau schedule, checkpoints and resume.

The port of the JAX package's ``training/trainer.py``, on one device:

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
instead, so the draws differ. Data parallelism over a mesh
(``Trainer(mesh=...)`` in JAX) waits for the port's ``torch.distributed``
work (ROADMAP queue 1, item 4); this trainer runs on one device.
"""

from __future__ import annotations

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


class Trainer:
    """Train one autoencoder variant on host numpy arrays, on ``device``
    (default CUDA; the CPU only when asked)."""

    def __init__(self, model: nn.Module, ae_type: str, cfg: TrainingConfig,
                 device="cuda"):
        if ae_type not in ("vae", "dae", "cae"):
            raise ValueError(f"unknown ae_type {ae_type!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.ae_type = ae_type
        self.cfg = cfg
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, cfg.learning_rate,
                                        cfg.weight_decay)

    # -- steps --------------------------------------------------------------

    def loss(self, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None,
             eps: torch.Tensor | None = None) -> torch.Tensor:
        """The variant's fp32 loss on one batch; the VAE samples with
        ``eps`` when given, else from ``generator``."""
        cfg = self.cfg
        if self.ae_type == "vae":
            recon, mu, logvar = self.model(batch["x"], train=True,
                                           generator=generator, eps=eps)
            return vae_loss(recon, batch["y"], mu, logvar, beta=cfg.beta)[0]
        if self.ae_type == "dae":
            return dae_loss(self.model(batch["x"]), batch["y"])
        enc = self.model.encode
        # when mining in-batch hard negatives the dataset's negatives are
        # unused, so they are not encoded
        z_n = (enc(batch["n"]) if "n" in batch and not cfg.mine_hard_negatives
               else None)
        return contrastive_loss(enc(batch["q"]), enc(batch["p"]), z_n,
                                margin=cfg.triplet_margin,
                                mine_hard_negatives=cfg.mine_hard_negatives)

    def train_step(self, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
        """One optimizer step; returns the batch's loss (on the device)."""
        loss = self.loss(batch, generator, eps)
        grads = grads_of(loss, self.params)
        apply_gradients(self.optimizer, grads, self.cfg.grad_clip_norm)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch: Mapping[str, torch.Tensor],
                  generator: torch.Generator | None = None) -> torch.Tensor:
        return self.loss(batch, generator)

    # -- data plumbing ------------------------------------------------------

    def _device_batch(self, arrays: Mapping[str, np.ndarray]) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _batches(self, data, batch_size, rng=None, drop_last=True):
        keys = list(data.keys())
        n = len(data[keys[0]])
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
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
                    save_weights(best_state, checkpoint_path)
                    save_training_state(state_path, self.model,
                                        self.optimizer, epoch, best_val)
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
        return TrainResult(params=best_state, best_val_loss=best_val,
                           epochs_ran=epochs_ran, history=history,
                           stopped_early=stopped)
