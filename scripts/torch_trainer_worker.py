"""One process of the port's two-process data-parallel AE training.

Launched once a rank by ``tests/test_torch_trainer_mesh.py`` (CPU shards)
and by ``chip_smoke.py`` phase 5g (shards on the card). The processes start
``torch.distributed`` on gloo (``parallel.initialize_distributed``) and
form one global mesh of ``--num_processes`` x ``--local_devices`` shards;
on it each trains, from the same seeded init and data (``data``), the DAE
and the CAE (``mine_hard_negatives``) with ``Trainer(mesh=)`` for
``--epochs`` epochs, rank 0 writing the checkpoints under
``--checkpoint_dir``, then resumes the DAE from them for one more epoch.
Before training it takes each variant's first step on a fixed batch
(``Trainer.step_grads``: the global loss and the gradient summed over the
shards and the processes) without applying it. Each process writes that
loss and gradient, its latents of a fixed probe and its histories to
``<--out>.<rank>.npz`` and prints ``TORCH_TRAINER_OK`` last; the caller
holds them against each other and against one process. ``--shape``
picks the AE widths and training sizes (``SHAPES``): ``small`` for the
CPU tests, ``config`` for the configs' own. The worker imports only the
port.

  python scripts/torch_trainer_worker.py --process_id 0 --num_processes 2 \\
      --coordinator localhost:29511 --out /tmp/res --checkpoint_dir /tmp/ck
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dataclasses import dataclass


@dataclass(frozen=True)
class Shape:
    """The AE widths and training sizes every process (and the caller)
    uses."""

    input_dim: int
    latent_dim: int
    hidden_dim: int
    rows: int
    val_rows: int
    batch: int
    learning_rate: float


SHAPES = {
    "small": Shape(32, 8, 16, rows=128, val_rows=40, batch=32,
                   learning_rate=1e-2),
    # configs/default.yaml's models.{vae,dae,cae} widths (also
    # msmarco_v5e8.yaml's) and its training.batch_size / learning_rate;
    # 1024 rows, so 3 epochs are 24 steps of the config's batch
    "config": Shape(384, 64, 512, rows=1024, val_rows=256, batch=128,
                    learning_rate=1e-3),
}
SMALL = SHAPES["small"]


def data(ae_type: str, n: int, seed: int, shape: Shape = SMALL):
    """Seeded rows: (x noisy, y clean) for the DAE, (q, p) for the CAE."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = shape.input_dim
    if ae_type == "cae":
        return {k: rng.standard_normal((n, d)).astype(np.float32)
                for k in ("q", "p")}
    y = rng.standard_normal((n, d)).astype(np.float32)
    return {"x": y + 0.05 * rng.standard_normal(y.shape).astype(np.float32),
            "y": y}


def config(ae_type: str, epochs: int, shape: Shape = SMALL):
    from latentrag_torch.utils.config import TrainingConfig

    if ae_type == "cae":
        return TrainingConfig(batch_size=shape.batch, epochs=epochs,
                              learning_rate=shape.learning_rate,
                              weight_decay=1e-4, grad_clip_norm=1.0,
                              mine_hard_negatives=True,
                              early_stop_patience=100, seed=7)
    return TrainingConfig(batch_size=shape.batch, epochs=epochs,
                          learning_rate=shape.learning_rate,
                          early_stop_patience=100, seed=7)


def train(ae_type: str, epochs: int, device, mesh=None, checkpoint=None,
          resume=False, shape: Shape = SMALL):
    """(trainer, result) of one fit from the seeded init."""
    from latentrag_torch.models import build_autoencoder
    from latentrag_torch.training.trainer import Trainer
    from latentrag_torch.utils.config import AutoencoderConfig

    acfg = AutoencoderConfig(input_dim=shape.input_dim,
                             latent_dim=shape.latent_dim,
                             hidden_dim=shape.hidden_dim)
    trainer = Trainer(build_autoencoder(ae_type, acfg), ae_type,
                      config(ae_type, epochs, shape), device=device,
                      mesh=mesh)
    res = trainer.fit(data(ae_type, shape.rows, 1, shape),
                      data(ae_type, shape.val_rows, 2, shape),
                      checkpoint_path=checkpoint, resume=resume)
    return trainer, res


def first_step(ae_type: str, device, mesh=None, shape: Shape = SMALL):
    """The first step's loss and gradient on a fixed global batch of
    ``shape.batch`` rows, from the seeded init, as numpy: on a mesh the
    gradient summed over the shards and the processes (``step_grads``),
    on one device ``grads_of`` the batch's loss."""
    trainer, _ = train(ae_type, 0, device, mesh, shape=shape)
    batch = trainer._device_batch(data(ae_type, shape.batch, 5, shape))
    loss, grads = trainer.step_grads(batch)
    return loss.item(), [g.float().cpu().numpy() for g in grads]


def probe_latents(trainer, shape: Shape = SMALL):
    import numpy as np
    import torch

    x = np.random.default_rng(9).standard_normal(
        (6, shape.input_dim)).astype(np.float32)
    with torch.no_grad():
        z = trainer.model.encode(torch.from_numpy(x).to(trainer.device))
    z = z[0] if isinstance(z, tuple) else z
    return z.float().cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--local_devices", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="small")
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the rendezvous and each collective")
    args = ap.parse_args(argv)

    import numpy as np

    from latentrag_torch.parallel import global_mesh, initialize_distributed

    if not initialize_distributed(args.coordinator, args.num_processes,
                                  args.process_id, backend="gloo",
                                  timeout=args.timeout):
        print("FATAL: the process group did not come up", flush=True)
        return 2
    shape = SHAPES[args.shape]
    mesh = global_mesh(devices=[args.device] * args.local_devices)
    rank = mesh.rank
    out = {}
    for ae_type in ("dae", "cae"):
        loss, grads = first_step(ae_type, args.device, mesh, shape)
        out[f"{ae_type}_step_loss"] = np.array(loss)
        for i, g in enumerate(grads):
            out[f"{ae_type}_step_grad_{i}"] = g
        ckpt = os.path.join(args.checkpoint_dir, f"{ae_type}.pth")
        trainer, res = train(ae_type, args.epochs, args.device, mesh, ckpt,
                             shape=shape)
        out[f"{ae_type}_latents"] = probe_latents(trainer, shape)
        out[f"{ae_type}_history"] = np.array(res.history)
        print(f"proc {rank}: {ae_type} trained on {mesh.size} shards",
              flush=True)
    # every process resumes from the files process 0 wrote
    trainer, res = train("dae", args.epochs + 1, args.device, mesh,
                         os.path.join(args.checkpoint_dir, "dae.pth"),
                         resume=True, shape=shape)
    out["dae_resumed_epochs"] = np.array([h[0] for h in res.history])
    out["dae_resumed_latents"] = probe_latents(trainer, shape)
    np.savez(f"{args.out}.{rank}.npz", **out)
    assert "jax" not in sys.modules and "latentrag_tpu" not in sys.modules
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"TORCH_TRAINER_OK process={rank}/{args.num_processes} "
          f"shards={mesh.size}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
