"""One process of the port's two-process sharded run.

Launched once a rank by ``tests/test_torch_multiprocess.py`` (CPU shards)
and by ``chip_smoke.py`` phase 5d (shards on the card). The processes
start ``torch.distributed`` on gloo (``parallel.initialize_distributed``)
and form one global mesh of ``--num_processes`` x ``--local_devices``
shards (``parallel.global_mesh``); on it each runs, over the same seeded
rows:

1. the sharded exact search (``make_sharded_topk(backend="exact")``) of a
   ``--dtype`` store, unfiltered and with a row mask;
2. the sharded SQ8 search of the rows' int8 codes;
3. the sharded binary stage 1 of their sign words;
4. the ring k-NN graph (``sharded_knn_graph``, exact), the shards sent
   between the processes;
5. the sharded IVF (``parallel.ivf``): each process builds its shards'
   inverted files (the padded block count agreed across the processes),
   searched at a partial probe; its centroids and assignments gathered;
6. with ``--checkpoint_dir``: ``save_sharded_index`` from both processes,
   reloaded on the global mesh (the search must not move), and a
   ``DenseRetriever(mesh=)`` built, searched and saved from both, then one
   with the device IVF (its ``ivf_mesh_p`` sidecar written by process 0).

Each process writes its results to ``<--out>.<rank>.npz`` and prints
``TORCH_MULTIPROC_OK`` last; the caller holds them against each other and
against its own single-process search. The worker imports only the port.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def data(n: int, d: int, nq: int, seed: int = 7):
    """The rows and queries every process (and the caller) builds: unit
    rows, a tenth of the rows masked in."""
    import numpy as np

    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    mask = rng.random(n) < 0.1
    return corpus, queries, mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--local_devices", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint_dir", default="")
    ap.add_argument("--n", type=int, default=1001)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--knn_n", type=int, default=203)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the rendezvous and each collective")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from latentrag_torch.ops.binary import binary_quantize
    from latentrag_torch.ops.quantization import sq8_quantize
    from latentrag_torch.parallel import (
        global_mesh,
        initialize_distributed,
        load_sharded_index,
        make_sharded_topk,
        save_sharded_index,
        shard_rows,
        sharded_knn_graph,
    )
    from latentrag_torch.parallel.mesh import gather_rows

    if not initialize_distributed(args.coordinator, args.num_processes,
                                  args.process_id, backend="gloo",
                                  timeout=args.timeout):
        print("FATAL: the process group did not come up", flush=True)
        return 2
    mesh = global_mesh(devices=[args.device] * args.local_devices)
    assert mesh.size == args.num_processes * args.local_devices
    rank = mesh.rank
    corpus, queries, mask = data(args.n, args.d, args.queries)
    dtype = getattr(torch, args.dtype)
    c = torch.tensor(corpus).to(dtype)
    q = torch.tensor(queries)
    out = {}

    exact = make_sharded_topk(mesh, k=args.k, backend="exact")
    c_sh = shard_rows(c, mesh)
    s, i = exact(q, c_sh, args.n)
    out["exact_s"], out["exact_i"] = s.cpu().numpy(), i.cpu().numpy()
    filt = make_sharded_topk(mesh, k=args.k, backend="exact", filtered=True)
    s, i = filt(q, c_sh, args.n,
                mask_shard=shard_rows(torch.tensor(mask), mesh))
    out["filtered_s"], out["filtered_i"] = s.cpu().numpy(), i.cpu().numpy()
    print(f"proc {rank}: exact sharded top-k", flush=True)

    codes, scale = sq8_quantize(torch.tensor(corpus))
    s, i = make_sharded_topk(mesh, k=args.k, backend="sq8")(
        q, shard_rows(codes, mesh), args.n, float(scale))
    out["sq8_s"], out["sq8_i"] = s.cpu().numpy(), i.cpu().numpy()
    out["codes"], out["scale"] = codes.numpy(), np.float32(scale)
    print(f"proc {rank}: SQ8 sharded top-k", flush=True)

    words = binary_quantize(torch.tensor(corpus))
    s, i = make_sharded_topk(mesh, k=4 * args.k, backend="binary",
                             d=args.d)(q, shard_rows(words, mesh), args.n)
    out["binary_s"], out["binary_i"] = s.cpu().numpy(), i.cpu().numpy()
    print(f"proc {rank}: binary sharded stage 1", flush=True)

    knn_rows = torch.tensor(corpus[: args.knn_n])
    out["knn"] = sharded_knn_graph(knn_rows.to(args.device), 8, mesh,
                                   exact=True)
    print(f"proc {rank}: ring k-NN graph", flush=True)

    from latentrag_torch.parallel.ivf import (
        build_sharded_ivf,
        make_sharded_ivf_topk,
        sharded_ivf_assignments,
        sharded_ivf_centroids,
    )

    sivf = build_sharded_ivf(c_sh, mesh, nlist=32, cap=16)
    s, i = make_sharded_ivf_topk(mesh, k=args.k, nprobe=8)(q, sivf, args.n)
    out["ivf_s"], out["ivf_i"] = s.cpu().numpy(), i.cpu().numpy()
    out["ivf_nblocks"] = np.int64(sivf.nblocks)
    out["ivf_mlb"] = np.int64(sivf.max_list_blocks)
    out["ivf_cent"] = sharded_ivf_centroids(sivf)
    out["ivf_assign"] = sharded_ivf_assignments(sivf)
    print(f"proc {rank}: sharded IVF", flush=True)

    if args.checkpoint_dir:
        from latentrag_torch.retrieval import DenseRetriever

        ckpt = os.path.join(args.checkpoint_dir, "sharded")
        save_sharded_index(ckpt, c_sh, {"n": args.n})
        restored, meta = load_sharded_index(ckpt, mesh)
        assert meta["n"] == args.n and meta["p"] == mesh.size
        s2, i2 = exact(q, restored, args.n)
        assert np.array_equal(i2.cpu().numpy(), out["exact_i"])
        assert np.array_equal(s2.cpu().numpy(), out["exact_s"])
        assert torch.equal(gather_rows(restored, args.n).cpu(), c)
        print(f"proc {rank}: sharded checkpoint round-trip ok", flush=True)
        r = DenseRetriever(backend="xla_exact", store_dtype=args.dtype,
                           mesh=mesh, device=args.device,
                           index_path=os.path.join(args.checkpoint_dir,
                                                   "dense"))
        r.build(corpus, [f"doc {j}" for j in range(args.n)])
        s, i = r.search(queries, args.k)
        out["dense_s"], out["dense_i"] = s, i
        print(f"proc {rank}: sharded DenseRetriever saved", flush=True)
        r = DenseRetriever(backend="xla", store_dtype=args.dtype, mesh=mesh,
                           device=args.device, ivf_nlist=32, ivf_cap=16,
                           ivf_nprobe=8, index_path=os.path.join(
                               args.checkpoint_dir, "dense_ivf"))
        r.IVF_MIN_ROWS = 512  # this small corpus routes through the IVF
        r.build(corpus, [f"doc {j}" for j in range(args.n)])
        s, i = r.search(queries, args.k)
        out["dense_ivf_s"], out["dense_ivf_i"] = s, i
        print(f"proc {rank}: sharded IVF DenseRetriever saved", flush=True)

    np.savez(f"{args.out}.{rank}.npz", **out)
    assert "jax" not in sys.modules and "latentrag_tpu" not in sys.modules
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"TORCH_MULTIPROC_OK process={rank}/{args.num_processes} "
          f"shards={mesh.size}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
