"""Deployment readiness checks of the port: ``python -m latentrag_torch.doctor``.

One command that answers "will this machine serve?" before anything is
deployed on it, the counterpart of the JAX package's doctor (which probes
a TPU relay; this one probes CUDA and the port's kernels):

* imports: torch, its CUDA build, ``nvcc`` on the PATH;
* platform: the card's name; FAIL without a card unless ``--device cpu``;
* kernels: build (or load) the fold, exact and IVF libraries, then launch
  the bf16 fold and the bf16 exact kernel once on a small case and hold
  each to its plain version (skipped, a warning, under ``--device cpu``);
* native: the C++ library (build + ABI);
* tokenizer: the C++ WordPiece fast path;
* the stores at ``--index`` (the dense store's meta, texts, sidecars,
  generation and sampled digests; the HNSW / IVF-PQ sidecars), each under
  its own crash guard; a ``sharded/`` store's meta, row count,
  generation tag and shard files, as the JAX doctor checks its meta and
  generation (the JAX package's Orbax layout fails, naming the script that
  rewrites it);
* checkpoints: encoder / reranker ``.msgpack``, AE ``.pth``, and the JAX
  trainer's Orbax AE directories, which get a warning naming the command
  that converts them.

The human report goes to stderr; stdout carries exactly one JSON line,
``{"doctor": {...}}``. Exit code 0 = no failures, 1 = at least one FAIL
(a check that crashes is a FAIL). Warnings never fail the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .pipeline import ORBAX_SCRIPT

PASS, WARN, FAIL = "pass", "warn", "fail"


def _versions(device: str):
    from .ops import cuda_build

    try:
        nvcc = cuda_build._nvcc()
    except RuntimeError:
        nvcc = None
    detail = (f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
              f"numpy {np.__version__}, nvcc {nvcc or 'not found'}")
    if device == "cuda" and nvcc is None:
        return WARN, detail + " — the kernels cannot be built", []
    return PASS, detail, []


def _platform(device: str):
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        return PASS, f"device {device}; {len(names)} card(s): {names}", []
    if device == "cpu":
        return PASS, "device cpu (the plain PyTorch path); no card", []
    return FAIL, ("torch.cuda.is_available() is False; the port runs on "
                  "the card (pass --device cpu to check the CPU path)"), []


def _kernels(device: str):
    """Build or load the kernels' libraries, then one fold and one exact
    launch on the card, each against its plain version."""
    if device == "cpu":
        return WARN, "skipped under --device cpu", []
    if not torch.cuda.is_available():
        return FAIL, "no card to build and launch the kernels on", []
    from .ops import cuda_build
    from .ops import fused_topk as ft
    from .ops import ivf

    cuda_build.load_libraries(ft.LIBRARIES + ivf.LIBRARIES)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.nn.functional.normalize(
        torch.randn((37, 64), generator=g, device="cuda"), dim=1)
    c = torch.nn.functional.normalize(
        torch.randn((5003, 64), generator=g, device="cuda"), dim=1)
    q, c = q.to(torch.bfloat16), c.to(torch.bfloat16)
    notes = []
    for mode, k in (("fold", 10), ("exact", 10)):
        s_k, i_k = ft.fused_topk_raw(q, c, k=k, mode=mode, block_n=128)
        ran = ft.last_kernel
        s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, mode=mode,
                                               block_n=128)
        same = float((i_k == i_p).float().mean())
        err = float((s_k - s_p).abs().max())
        notes.append(f"{mode}: {ran}, ids {same:.4f} of plain, "
                     f"max |score error| {err:.2e}")
        if same < 0.99 or err > 1e-3:
            return FAIL, f"the {mode} kernel disagrees with its plain " \
                         f"version ({notes[-1]})", notes
    return PASS, "fold and exact kernels built, launched and held to " \
                 "their plain versions", notes


def _native():
    from .utils import native

    native.load_library()
    return PASS, f"C++ library loaded (ABI {native.ABI_VERSION})", []


def _tokenizer_native():
    from .data.tokenizer import CLS, PAD, SEP, UNK, WordPieceTokenizer

    vocab = {PAD: 0, UNK: 1, CLS: 2, SEP: 3, "hello": 4, "world": 5}
    tok = WordPieceTokenizer(vocab)
    if tok._native_handle() is not None:
        ids, _ = tok.encode_batch(["hello world"])
        return PASS, "C++ WordPiece fast path active " \
                     f"(batch shape {ids.shape})", []
    return WARN, "C++ WordPiece unavailable — the Python path serves", []


def _dense_store(path: str):
    """Cross-check a dense index directory the way a warm boot would, plus
    the sidecar checks a boot defers."""
    from .retrieval.dense import verify_stored_digests
    from .retrieval.textstore import load_texts

    notes: list[str] = []
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        return FAIL, f"meta.json unreadable: {e}", notes
    n = int(meta.get("n", -1))
    texts, doc_ids = load_texts(os.path.join(path, "texts"))
    if texts is None:
        if "texts" in meta:
            texts = meta["texts"]
            notes.append("legacy store: texts inlined in meta.json")
        else:
            return FAIL, "no usable text store (lazy store invalid and " \
                         "meta.json has no texts)", notes
    if doc_ids is None:
        doc_ids = meta.get("doc_ids")
    if doc_ids is None:
        return FAIL, "no doc_ids (sidecar missing and none in meta)", notes
    if len(texts) != n or len(doc_ids) != n:
        return FAIL, (
            f"mixed-generation store: {len(texts)} texts / "
            f"{len(doc_ids)} doc_ids vs n={n}"
        ), notes

    def rows(name):
        p = os.path.join(path, name)
        if not os.path.exists(p):
            return None
        return int(np.load(p, mmap_mode="r").shape[0])

    corpus_rows = rows("corpus.npy")
    sharded = os.path.isdir(os.path.join(path, "sharded"))
    if corpus_rows is None and not sharded:
        return FAIL, "corpus.npy missing (and no sharded/ store)", notes
    if corpus_rows is not None and corpus_rows != n:
        return FAIL, f"corpus.npy holds {corpus_rows} rows vs n={n}", notes
    for name, tier in (("binary_packed.npy", "binary"),
                       ("sq4_packed.npy", "int4")):
        packed = rows(name)
        if packed is None:
            continue
        if packed != n:
            return FAIL, (f"{name} holds {packed} rows vs n={n} "
                          "(stale sidecar?)"), notes
        notes.append(f"{tier} tier sidecars present")
    # same-n mixed generations: each sidecar's sampled digest against
    # meta.json, as a warm boot checks them
    try:
        verify_stored_digests(path, meta)
    except ValueError as e:
        return FAIL, str(e), notes
    if sharded:
        status, why = _sharded_store(os.path.join(path, "sharded"), n,
                                     meta.get("sharded_generation"))
        if status == FAIL:
            return FAIL, why, notes
        notes.append(why)
    if os.path.exists(os.path.join(path, "whitener.npy")):
        notes.append("whitener present (mahalanobis/whitened metric)")
    fp = meta.get("fingerprint") or {}
    detail = (f"n={n}, metric={meta.get('metric')}, "
              f"fingerprint keys={sorted(fp)}" if fp
              else f"n={n}, no fingerprint")
    return PASS, detail, notes


def _sharded_store(path: str, n: int, want_gen):
    """A ``sharded/`` store against meta.json: its meta (the port's
    layout), row count and generation tag, and every shard file's shape,
    read off the headers."""
    from .parallel.checkpoint import read_sharded_meta

    try:
        smeta = read_sharded_meta(path, n, want_gen)
    except (OSError, ValueError) as e:
        return FAIL, f"sharded/: {e}"
    return PASS, (f"sharded/ store present and generation-consistent "
                  f"({smeta['p']} shards of {smeta['rows_per_shard']} "
                  f"rows, {smeta['dtype']})")


def _ann_store(stem: str, kind: str):
    """The sidecars of one ANN tier, without loading the C++ index."""
    from .retrieval.textstore import load_texts

    notes: list[str] = []
    try:
        with open(stem + ".meta.json") as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        return FAIL, f"{kind} meta unreadable: {e}", notes
    texts, doc_ids = load_texts(stem + ".texts")
    if texts is None and "texts" not in meta:
        return FAIL, f"{kind} store has no usable texts", notes
    n = len(texts) if texts is not None else len(meta["texts"])
    ids = doc_ids if doc_ids is not None else meta.get("doc_ids")
    if ids is None:
        return FAIL, f"{kind}: no doc_ids sidecar and none in meta " \
                     "(warm boot would cold-start)", notes
    if len(ids) != n:
        return FAIL, f"{kind}: {n} texts vs {len(ids)} doc_ids", notes
    rpath = stem + ".refine.npy"
    if os.path.exists(rpath):
        rrows = int(np.load(rpath, mmap_mode="r").shape[0])
        if rrows != n:
            return FAIL, (
                f"{kind}: refine sidecar holds {rrows} rows for {n} "
                "texts (stale sidecar — warm boot would cold-start)"
            ), notes
        notes.append(f"refine sidecar present ({rrows} rows)")
    fp = meta.get("fingerprint") or {}
    return PASS, f"{kind}: {n} texts, fingerprint keys={sorted(fp)}", notes


def _guarded(fn, *a):
    """``fn(*a)``; a check that crashes is a FAIL row, so stdout keeps its
    one JSON line whatever a corrupted file does to the check."""
    try:
        return fn(*a)
    except Exception as e:
        return FAIL, f"check crashed: {e!r}", []


def _stores(index_path: str):
    """(name, status, detail, notes) for every store at the path."""
    found = False
    if os.path.exists(os.path.join(index_path, "meta.json")):
        found = True
        yield ("store:dense", *_guarded(_dense_store, index_path))
    for kind in ("hnsw", "ivfpq"):
        stem = f"{index_path}.{kind}"
        if os.path.exists(stem + ".meta.json"):
            found = True
            yield (f"store:{kind}", *_guarded(_ann_store, stem, kind))
    if not found:
        yield "store", WARN, (
            f"no persisted store at {index_path} (first boot will be cold)"
        ), []


def _checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return WARN, f"{ckpt_dir} absent — the encoder takes a seeded " \
                     "init, AE pipelines need training first", []
    names = sorted(os.listdir(ckpt_dir))
    msgpacks = [n for n in names if n.endswith(".msgpack")]
    pths = [n for n in names if n.endswith(".pth")]
    orbax = [n for n in names if os.path.isfile(
        os.path.join(ckpt_dir, n, "_CHECKPOINT_METADATA"))]
    detail = (f"{len(msgpacks)} msgpack checkpoint(s), AE .pth: "
              f"{pths or 'none'}")
    unconverted = [n for n in orbax if f"{n}.pth" not in names]
    if unconverted:
        cmds = [f"python {ORBAX_SCRIPT} --checkpoint "
                f"{os.path.join(ckpt_dir, n)} --ae_type <vae|dae|cae>"
                for n in unconverted]
        return WARN, (f"{detail}; Orbax AE checkpoint(s) {unconverted} "
                      "have no .pth, which the port reads: run, where the "
                      "JAX package is installed, " + "; ".join(cmds)), []
    return PASS, detail, []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="latentrag_torch deployment readiness checks"
    )
    ap.add_argument("--index", default=None,
                    help="index_path to health-check (default: config's)")
    ap.add_argument("--checkpoints", default=None,
                    help="checkpoints dir (default: config's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="'cuda' (default): the card and its kernels must "
                         "work; 'cpu': check the plain PyTorch path")
    args = ap.parse_args(argv)

    if args.index is None or args.checkpoints is None:
        from .utils.config import load_config

        cfg = load_config()
        if args.index is None:
            args.index = cfg.retrieval.index_path
        if args.checkpoints is None:
            args.checkpoints = cfg.paths.checkpoints_dir

    checks: list[tuple[str, str, str, list[str]]] = []

    def run(name, fn, *a):
        checks.append((name, *_guarded(fn, *a)))

    run("imports", _versions, args.device)
    run("platform", _platform, args.device)
    run("kernels", _kernels, args.device)
    run("native", _native)
    run("tokenizer", _tokenizer_native)
    checks.extend(_stores(args.index))
    run("checkpoints", _checkpoints, args.checkpoints)

    counts = {PASS: 0, WARN: 0, FAIL: 0}
    mark = {PASS: "ok  ", WARN: "WARN", FAIL: "FAIL"}
    for name, status, detail, notes in checks:
        counts[status] += 1
        print(f"[doctor] {mark[status]} {name}: {detail}", file=sys.stderr)
        for note in notes:
            print(f"[doctor]      - {note}", file=sys.stderr)
    print(
        f"[doctor] {counts[PASS]} ok, {counts[WARN]} warnings, "
        f"{counts[FAIL]} failures", file=sys.stderr,
    )
    print(json.dumps({
        "doctor": {
            "ok": counts[FAIL] == 0,
            "pass": counts[PASS], "warn": counts[WARN],
            "fail": counts[FAIL],
            "checks": {
                name: {"status": status, "detail": detail}
                for name, status, detail, _ in checks
            },
        }
    }), flush=True)
    return 0 if counts[FAIL] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
