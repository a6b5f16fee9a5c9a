"""Time TPU kernel rows 3, 4 and 6 of a checkout on the card: the reverse
sweep of the fused dense D-MPNN block from the stash (row 3) and with the
forward replayed (row 4) at the packed training batch (B = 32, E = 128, d =
256, depth 3, sum, residual), and the fused encoder's backward (row 6) at the
per-molecule dense loader's first batch (B = 64, V = 48, E = 128), as
``chip_smoke.py``'s time phase does (``time_sweep``: device ms a call from a
CUDA graph of 20 calls, and a ``torch.profiler`` breakdown of 5 calls by
kernel and by stage); with ``--e2e``, also a warm epoch of the declarative
D-MPNN config (the whole fused encoder, rows 5 and 6) under
``torch.profiler``: the card's busy milliseconds a step, row 6's share of
them, and the busy share of the wall time. ``--bf16`` also times rows 3b,
4b and 6b the same way (``matmul_dtype="bfloat16"``; rows 3b and 6b from
the bf16 stash, as the bf16 encoder config runs them), after the f32 rows.
Each line carries a ``sha256`` of the row's outputs and whether two calls
gave the same bits, so two trees' bits can be compared. ``--define
NAME=VALUE`` times a variant of the checkout: its package copied to a
temporary directory with ``constexpr int NAME = ...`` set to VALUE in
``csrc/dense_mpnn_bwd.cu`` (for example ``kSumAhead=4``). ``--stages``
(with ``--bf16``) builds such a copy with ``kStages = 1``, whose bf16
products stamp ``%globaltimer`` in every job (start, products summed,
output written, end), and prints for the last product launch of a call of
each bf16 row (layer 0's) the weight-gradient and input-gradient jobs'
phases in µs from the launch's first start: median and last of each, and
the chunk sums of the last blocks of the g_W tiles.

    python3 scripts/time_dense_mpnn_bwd.py [--root DIR] [--bf16] [--define NAME=VALUE ...] [--stages] [--e2e]

``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one); its ``csrc/*.cu`` are built there at first use. The inputs and the
timing are this checkout's, so two trees, for example a parent commit
unpacked with ``git archive``, are timed the same way in one call on one
card. Prints one JSON line a kernel, then the card's name and power limit.
"""

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import sys
import tempfile
from pathlib import Path

from time_csr_segment import variant

HERE = Path(__file__).resolve().parents[1]
# the sweep's kernels by name in a profile: this tree's stages, and the four
# kernels a layer of the sweep before its redesign for Hopper (an adjoint, a
# weight-gradient partial, a chunk reduce, an input gradient)
SWEEP_KERNELS = ("bwd_prep_", "bwd_adjoint_", "bwd_gemm_", "bwd_node_grad_", "adjoint_kernel",
                 "weight_grad_partial_kernel", "reduce_chunks_kernel", "input_grad_kernel")


def digest(tensors) -> str:
    """A sha256 of the bits of a row's outputs, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE), help="the checkout whose kernels run")
    parser.add_argument("--bf16", action="store_true", help="also time rows 3b, 4b and 6b (matmul_dtype bfloat16)")
    parser.add_argument("--define", action="append", default=[], help="NAME=VALUE in csrc/dense_mpnn_bwd.cu")
    parser.add_argument("--stages", action="store_true", help="stamp the bf16 products' jobs (kStages = 1)")
    parser.add_argument("--e2e", action="store_true", help="also profile a warm declarative D-MPNN epoch")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix="time_dense_mpnn_bwd_") as tmp:
        root = Path(args.root).resolve()
        defines = args.define + (["kStages=1"] if args.stages else [])
        if defines:
            root = variant(root, defines, Path(tmp) / "variant", "dense_mpnn_bwd.cu")
        run(args, root)


def job_stamps(lib, call, jobs: int, w_jobs: int) -> dict:
    """One call in a --stages build: the stamps of its last bf16 product
    launch, in µs from that launch's first start, for the weight-gradient
    jobs (the first ``w_jobs`` blocks) and the input-gradient ones."""
    import torch

    lib.dense_mpnn_bwd_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    jobs = min(jobs, 4096)
    out = (ctypes.c_ulonglong * (4 * jobs))()
    torch.cuda.synchronize()
    if lib.dense_mpnn_bwd_stamps_reset() != 0:
        raise SystemExit("dense_mpnn_bwd_stamps_reset failed")
    call()
    torch.cuda.synchronize()
    if lib.dense_mpnn_bwd_stamps_read(out, jobs) != 0:
        raise SystemExit("dense_mpnn_bwd_stamps_read failed")
    rows = [list(out[4 * b: 4 * b + 4]) for b in range(jobs)]
    t0 = min(r[0] for r in rows if r[0])

    def phases(block_rows):
        live = [r for r in block_rows if r[0]]
        if not live:
            return None
        summary = {"jobs": len(live)}
        for i, name in ((0, "start"), (1, "products"), (2, "written"), (3, "end")):
            at = sorted((r[i] - t0) / 1e3 for r in live)
            summary[name] = {"median": at[len(at) // 2], "last": at[-1]}
        spans = sorted((r[1] - r[0]) / 1e3 for r in live)
        summary["products_us"] = {"median": spans[len(spans) // 2], "max": spans[-1]}
        sums = sorted(((r[3] - r[2]) / 1e3 for r in live), reverse=True)
        summary["longest_ends_us"] = sums[:4]
        return summary

    return {"weight_jobs": phases(rows[:w_jobs]), "input_jobs": phases(rows[w_jobs:])}


def run(args, root: Path) -> None:
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("no CUDA device is available; this script times kernels on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    d, depth = smoke.MODEL_CFG["hidden_dim"], smoke.MODEL_CFG["depth"]
    with tempfile.TemporaryDirectory(prefix="time_dense_mpnn_bwd_") as tmp:
        csv_path = smoke.lipo_csv(Path(tmp), smoke.N_MOLS)
        ds = smoke.build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
        packed_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH)))["inputs.G"]
        dense_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH, layout="dense")))["inputs.G"]
        h0, src, dst, mask, W, b = smoke.kernel_inputs(packed_G, d, depth, smoke.SEED)
        g = smoke.cotangent(packed_G, d, smoke.SEED + 10)
        kw = dict(depth=depth, n_nodes=packed_G.nodes_per_graph, residual=True, reduce="sum")
        _, hs = smoke.fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, **kw)
        nf, ef, esrc, edst, emask, eW, eb, gn, ge = smoke.encoder_inputs(dense_G, d, depth, smoke.SEED + 2)
        enc_kw = dict(depth=depth, residual=True, reduce="sum")
        _, _, enc_hs = smoke.fused_dense_encoder_fwd(nf, ef, esrc, edst, emask, eW, eb, stash=True, **enc_kw)
        block_shape = {"B": h0.shape[0], "E": h0.shape[1], "d": d}
        enc_shape = {"B": ef.shape[0], "V": nf.shape[1], "E": ef.shape[1], "d": d}
        runs = [
            ("fused_dense_mpnn_block_bwd_stash",
             lambda: smoke.fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw), block_shape),
            ("fused_dense_mpnn_block_bwd",
             lambda: smoke.fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw), block_shape),
            ("fused_dense_encoder_bwd",
             lambda: smoke.fused_dense_encoder_bwd(nf, ef, enc_hs, esrc, edst, emask, eW, gn, ge, **enc_kw),
             enc_shape),
        ]
        if args.bf16:  # rows 3b and 6b from the bf16 stash, row 4b replaying in f32
            mm, half = dict(matmul_dtype="bfloat16"), dict(stash_dtype="bfloat16")
            _, hs_b = smoke.fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, **kw, **mm, **half)
            _, _, enc_hs_b = smoke.fused_dense_encoder_fwd(nf, ef, esrc, edst, emask, eW, eb, stash=True, **enc_kw,
                                                           **mm, **half)
            runs += [
                ("fused_dense_mpnn_block_bwd_stash_bf16",
                 lambda: smoke.fused_dense_mpnn_block_bwd_stash(h0, hs_b, src, dst, mask, W, g, **kw, **mm),
                 {**block_shape, "stash_dtype": "bfloat16"}),
                ("fused_dense_mpnn_block_bwd_bf16",
                 lambda: smoke.fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw, **mm), block_shape),
                ("fused_dense_encoder_bwd_bf16",
                 lambda: smoke.fused_dense_encoder_bwd(nf, ef, enc_hs_b, esrc, edst, emask, eW, gn, ge, **enc_kw,
                                                       **mm), {**enc_shape, "stash_dtype": "bfloat16"}),
            ]
        for name, kernel, shape in runs:
            first, second = kernel(), kernel()
            torch.cuda.synchronize()
            t, breakdown, stages = smoke.time_sweep(kernel)
            record = {"root": args.root, **({"define": args.define} if args.define else {}),
                      "kernel": name, "shape": shape, "depth": depth,
                      "ms": t["device"], "eager_ms": t["eager"], "stages_ms": stages,
                      "sha256": digest(first), "repeatable": all(torch.equal(x, y) for x, y in zip(first, second)),
                      "kernels_of_5_calls": breakdown}
            if args.stages and name.endswith("_bf16"):
                from notorch_tpu_torch.kernels import build

                lib = build.load("dense_mpnn_bwd")
                if lib.dense_mpnn_bwd_stages_built() != 1:
                    raise SystemExit("--stages: the build does not stamp")
                R = shape["B"] * shape["E"]
                source = (root / "notorch_tpu_torch" / "csrc" / "dense_mpnn_bwd.cu").read_text()
                chunks = -(-R // int(re.search(r"constexpr int kMmaChunkRows = (\d+)", source).group(1)))
                tile = 64
                w_jobs = (d // tile) ** 2 * chunks
                record["stages_us"] = job_stamps(lib, kernel, w_jobs + -(-R // tile) * (d // tile), w_jobs)
            print(json.dumps(record), flush=True)
        if args.e2e:
            cfg = smoke.train_config(smoke.lipo_csv(Path(tmp), smoke.TRAIN_MOLS), None,
                                     smoke.declarative_model_cfg(d, depth))
            state = smoke.prepare(cfg)
            loader = state["train_loader"]
            smoke.fit(state["model"], loader, epochs=2)  # fills the featurization cache, warms up
            epoch = smoke.profile_busy(lambda: smoke.fit(state["model"], loader, epochs=1), top=40, width=160)
            steps = len(loader)
            row6 = sum(k["ms"] for k in epoch["top"] if any(s in k["name"] for s in SWEEP_KERNELS))
            print(json.dumps({"root": args.root, "declarative_steps": steps,
                              "profiled_step_device_ms": epoch["device_busy_ms"] / steps,
                              "profiled_step_row6_ms": row6 / steps,
                              "profiled_step_wall_ms": epoch["wall_ms"] / steps,
                              "profiled_step_busy_share": epoch["device_busy_share"]}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
