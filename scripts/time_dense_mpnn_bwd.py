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
them, and the busy share of the wall time.

    python3 scripts/time_dense_mpnn_bwd.py [--root DIR] [--e2e]

``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one); its ``csrc/*.cu`` are built there at first use. The inputs and the
timing are this checkout's, so two trees, for example a parent commit
unpacked with ``git archive``, are timed the same way in one call on one
card. Prints one JSON line a kernel, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the sweep's kernels by name in a profile: this tree's stages, and the four
# kernels a layer of the sweep before its redesign for Hopper (an adjoint, a
# weight-gradient partial, a chunk reduce, an input gradient)
SWEEP_KERNELS = ("bwd_prep_", "bwd_adjoint_", "bwd_gemm_", "bwd_node_grad_", "adjoint_kernel",
                 "weight_grad_partial_kernel", "reduce_chunks_kernel", "input_grad_kernel")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE), help="the checkout whose kernels run")
    parser.add_argument("--e2e", action="store_true", help="also profile a warm declarative D-MPNN epoch")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
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
        runs = {
            smoke.fused_dense_mpnn_block_bwd_stash: (
                lambda: smoke.fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw),
                {"B": h0.shape[0], "E": h0.shape[1], "d": d}),
            smoke.fused_dense_mpnn_block_bwd: (
                lambda: smoke.fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw),
                {"B": h0.shape[0], "E": h0.shape[1], "d": d}),
            smoke.fused_dense_encoder_bwd: (
                lambda: smoke.fused_dense_encoder_bwd(nf, ef, enc_hs, esrc, edst, emask, eW, gn, ge, **enc_kw),
                {"B": ef.shape[0], "V": nf.shape[1], "E": ef.shape[1], "d": d}),
        }
        for fn, (kernel, shape) in runs.items():
            t, breakdown, stages = smoke.time_sweep(kernel)
            print(json.dumps({"root": args.root, "kernel": fn.__name__, "shape": shape, "depth": depth,
                              "ms": t["device"], "eager_ms": t["eager"], "stages_ms": stages,
                              "kernels_of_5_calls": breakdown}), flush=True)
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
