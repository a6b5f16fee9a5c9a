"""Time TPU kernel rows 1, 2, 4, 5 and 7 of a checkout on the card: the
forward of the fused dense D-MPNN block (row 1), its stash forward (row 2),
the recompute backward, whose replay runs that forward (row 4), and the
depth-fused forward of the same function (row 7), at the packed training
batch (B = 32, E = 128, d = 256, depth 3, sum, residual),
and the fused encoder's forward with the stash (row 5) at the per-molecule
dense loader's first batch (B = 64, V = 48, E = 128), as ``chip_smoke.py``'s
time phase does: device ms a call from a CUDA graph of 20 calls, and a
``torch.profiler`` breakdown of 5 calls by kernel and by stage (the
forward's prep, products and operator pass, or the single layer kernel of a
tree from before them; row 4's sweep; row 7's one kernel, or row 7b's, or
the layer kernel before row 7's redesign). Each row runs twice and says whether the two
calls gave the same bits; rows 1, 5 and 7 also run with mean, and row 7
says whether it gave row 1's bits and, where the tree has them, how many of
its bin groups the launch runs at once. With
``--bits FILE`` the outputs are compared with those saved in FILE, bit for
bit: the first run that names FILE writes it, every later run prints
whether its outputs have the same bits. ``--bf16`` also runs rows 1b, 2b,
4b, 5b and 7b the same way after the f32 rows (``matmul_dtype="bfloat16"``;
rows 2b and 5b with the bf16 stash, as the bf16 encoder config runs them;
row 4b replays in f32 layer inputs), row 7b with whether it gave row 1b's
bits and its largest difference from them. Each line carries a ``sha256`` of
the row's outputs. In a build with ``--define kDbufStages=1`` rows 7 and 7b
also print their stage stamps (``stamps_us``): for block 0, µs after its
start, and for the span of all blocks, µs after the first block's start
until the last block's stamp, at the prologue's end and at each layer's
product, operator pass and group barrier. With ``--e2e``,
also a warm epoch of the declarative D-MPNN config (rows 5 and 6) under
``torch.profiler``: the card's busy milliseconds a step, and row 5's share
of them.

    python3 scripts/time_dense_mpnn_fwd.py [--root DIR] [--bits FILE] [--bf16] [--rows 1b,5b] [--define NAME=VALUE ...] [--e2e]

``--rows`` runs only the rows it names (for example ``--rows 1b,5b`` with
``--bf16``, to compare tile variants). ``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one); its ``csrc/*.cu`` are built there at first use. ``--define NAME=VALUE``
times a variant of that checkout: its package is copied to a temporary
directory with ``constexpr int NAME = ...`` set to VALUE in
``csrc/dense_mpnn.cu`` (for example ``kGemmRows=32``, ``kApplyThreads=512``,
the bf16 product's tile, ``kMmaCols=64``, row 7b's k-slab, ``kDbufMmaK=64``,
or the stamps, ``kDbufStages=1``).
The inputs and the timing are this checkout's, so two trees, for example a
parent commit unpacked with ``git archive``, are timed the same way in one
call on one card. Prints one JSON line a row, then the card's name and
power limit.
"""

import argparse
import hashlib
import importlib.util
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the forward's kernels by name in a profile, by stage: this tree's, and the
# layer kernel of the forward before its redesign for Hopper (one launch a
# layer, its ends folded into the encoder's first and last); row 4's sweep
STAGES = {
    "prep": ("mpnn_fwd_prep_",),
    "products": ("mpnn_fwd_gemm_",),
    "operator": ("mpnn_fwd_apply_",),
    "layer_kernel": ("dense_mpnn_plain_kernel", "dense_mpnn_ends_kernel"),
    "sweep": ("bwd_prep_", "bwd_adjoint_", "bwd_gemm_", "bwd_node_grad_"),
    "dbuf": ("dense_mpnn_dbuf_",),  # row 7's kernel, and row 7b's (dense_mpnn_dbuf_mma_kernel)
}
FWD_KERNELS = (*STAGES["prep"], *STAGES["products"], *STAGES["operator"], *STAGES["layer_kernel"])


def variant(root: Path, defines: list[str], into: Path) -> Path:
    """A copy of ``root``'s package under ``into`` with each NAME=VALUE set
    in ``csrc/dense_mpnn.cu``; returns the copy's root."""
    shutil.copytree(root / "notorch_tpu_torch", into / "notorch_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = into / "notorch_tpu_torch" / "csrc" / "dense_mpnn.cu"
    text = cu.read_text()
    for item in defines:
        name, value = item.split("=", 1)
        text, n = re.subn(rf"constexpr int {re.escape(name)} = [^,;]+", f"constexpr int {name} = {value}", text)
        if n != 1:
            raise SystemExit(f"--define {item}: csrc/dense_mpnn.cu has {n} definitions of {name}")
    cu.write_text(text)
    return into


# row 7's stamp slots (csrc/dense_mpnn.cu, dbuf_stamp): the bin's start,
# the prologue's end, then each layer's product, operator pass and barrier
def stamp_names(slots: int) -> list[str]:
    return ["start", "prologue"] + [f"layer{l}_{stage}" for l in range((slots - 2) // 3)
                                    for stage in ("product", "pass", "barrier")]


def dbuf_stamps(call, shape: dict) -> dict | None:
    """Rows 7 and 7b's stage stamps of one ``call`` in a build with
    kDbufStages = 1 (None in any other build): block 0's, µs after its start,
    and the span's, µs after the first block's start to the last block's
    stamp (the blocks that ran)."""
    import ctypes

    import numpy as np
    import torch
    from notorch_tpu_torch.kernels import dense_mpnn

    lib = dense_mpnn._layer_fns()[0]
    if not hasattr(lib, "dense_mpnn_dbuf_stages_built") or lib.dense_mpnn_dbuf_stages_built() == 0:
        return None
    slots = lib.dense_mpnn_dbuf_stamp_slots()
    blocks = min(shape["B"] * shape["d"] // lib.dense_mpnn_cols(), 1024)
    lib.dense_mpnn_dbuf_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.dense_mpnn_dbuf_stamps_reset() != 0:
        raise SystemExit("dense_mpnn_dbuf_stamps_reset failed")
    call()
    torch.cuda.synchronize()
    at = np.zeros((blocks, slots), dtype=np.uint64)
    if lib.dense_mpnn_dbuf_stamps_read(at.ctypes.data, blocks) != 0:
        raise SystemExit("dense_mpnn_dbuf_stamps_read failed")
    at = at[at[:, 0] != 0].astype(np.int64)  # the blocks that ran
    t0 = at[:, 0].min()
    block0, span = {}, {}
    for i, name in enumerate(stamp_names(slots)[1:], start=1):
        if at[0, i] != 0:
            block0[name] = float(at[0, i] - at[0, 0]) / 1000.0
        if (at[:, i] != 0).any():
            span[name] = float(at[:, i].max() - t0) / 1000.0
    return {"block0": block0, "span": span, "blocks": int(at.shape[0])}


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
    parser.add_argument("--bits", help="a file of outputs to compare with (written if missing)")
    parser.add_argument("--bf16", action="store_true", help="also rows 1b, 2b, 4b, 5b and 7b (matmul_dtype bfloat16)")
    parser.add_argument("--rows", help="only these rows, comma-separated (default: all)")
    parser.add_argument("--define", action="append", default=[], help="NAME=VALUE in csrc/dense_mpnn.cu")
    parser.add_argument("--e2e", action="store_true", help="also profile a warm declarative D-MPNN epoch")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix="time_dense_mpnn_fwd_") as tmp:
        root = Path(args.root).resolve()
        if args.define:
            root = variant(root, args.define, Path(tmp) / "variant")
        run(args, root, Path(tmp))


def run(args, root: Path, tmp: Path) -> None:
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("no CUDA device is available; this script times kernels on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    d, depth = smoke.MODEL_CFG["hidden_dim"], smoke.MODEL_CFG["depth"]
    tag = {"root": args.root, **({"define": args.define} if args.define else {})}
    csv_path = smoke.lipo_csv(tmp, smoke.N_MOLS)
    ds = smoke.build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
    packed_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH)))["inputs.G"]
    dense_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH, layout="dense")))["inputs.G"]
    x = smoke.kernel_inputs(packed_G, d, depth, smoke.SEED)
    g = smoke.cotangent(packed_G, d, smoke.SEED + 10)
    kw = dict(depth=depth, n_nodes=packed_G.nodes_per_graph, residual=True)
    enc = smoke.encoder_inputs(dense_G, d, depth, smoke.SEED + 2)
    enc_kw = dict(depth=depth, residual=True)
    block_shape = {"B": x[0].shape[0], "E": x[0].shape[1], "d": d}
    enc_shape = {"B": enc[1].shape[0], "V": enc[0].shape[1], "E": enc[1].shape[1], "d": d}
    # (row, reduce, its call on these inputs, returning a tuple of outputs);
    # the sum rows are timed, the mean rows checked only
    rows = [
        (1, "sum", lambda: (smoke.fused_dense_mpnn_block(*x, reduce="sum", **kw),)),
        (2, "sum", lambda: smoke.fused_dense_mpnn_block_stash(*x, reduce="sum", **kw)),
        (4, "sum", lambda: smoke.fused_dense_mpnn_block_bwd(*x, g, reduce="sum", **kw)),
        (5, "sum", lambda: smoke.fused_dense_encoder_fwd(*enc[:7], stash=True, reduce="sum", **enc_kw)),
        (7, "sum", lambda: (smoke.fused_dense_mpnn_block_dbuf(*x, mols_per_tile=8, reduce="sum", **kw),)),
        (1, "mean", lambda: (smoke.fused_dense_mpnn_block(*x, reduce="mean", **kw),)),
        (5, "mean", lambda: smoke.fused_dense_encoder_fwd(*enc[:7], stash=True, reduce="mean", **enc_kw)),
        (7, "mean", lambda: (smoke.fused_dense_mpnn_block_dbuf(*x, mols_per_tile=8, reduce="mean", **kw),)),
    ]
    if args.bf16:
        mm, half = dict(matmul_dtype="bfloat16"), dict(matmul_dtype="bfloat16", stash_dtype="bfloat16")
        rows += [
            ("1b", "sum", lambda: (smoke.fused_dense_mpnn_block(*x, reduce="sum", **kw, **mm),)),
            ("2b", "sum", lambda: smoke.fused_dense_mpnn_block_stash(*x, reduce="sum", **kw, **half)),
            ("4b", "sum", lambda: smoke.fused_dense_mpnn_block_bwd(*x, g, reduce="sum", **kw, **mm)),
            ("5b", "sum", lambda: smoke.fused_dense_encoder_fwd(*enc[:7], stash=True, reduce="sum", **enc_kw,
                                                                **half)),
            ("7b", "sum", lambda: (smoke.fused_dense_mpnn_block_dbuf(*x, mols_per_tile=8, reduce="sum", **kw,
                                                                     **mm),)),
            ("1b", "mean", lambda: (smoke.fused_dense_mpnn_block(*x, reduce="mean", **kw, **mm),)),
            ("5b", "mean", lambda: smoke.fused_dense_encoder_fwd(*enc[:7], stash=True, reduce="mean", **enc_kw,
                                                                 **half)),
            ("7b", "mean", lambda: (smoke.fused_dense_mpnn_block_dbuf(*x, mols_per_tile=8, reduce="mean", **kw,
                                                                      **mm),)),
        ]
    if args.rows:
        keep = set(args.rows.split(","))
        rows = [r for r in rows if str(r[0]) in keep]
    saved = None
    bits_path = Path(args.bits) if args.bits else None
    if bits_path is not None and bits_path.exists():
        saved = torch.load(bits_path)
    outputs = {}
    for row, reduce, call in rows:
        key = f"row{row}_{reduce}"
        first, second = ([t for t in out if t is not None] for out in (call(), call()))
        torch.cuda.synchronize()
        outputs[key] = [t.cpu() for t in first]
        record = {**tag, "row": row, "reduce": reduce, "shape": enc_shape if row in (5, "5b") else block_shape,
                  "depth": depth, "sha256": digest(first),
                  "repeatable": all(torch.equal(p, q) for p, q in zip(first, second))}
        if row == "7b" and f"row1b_{reduce}" in outputs:  # both sum each output k16 by k16 in ascending k
            ref = outputs[f"row1b_{reduce}"][0]
            record["row1b_bits"] = torch.equal(first[0].cpu(), ref)
            record["row1b_max_abs_err_over_max"] = float((first[0].cpu() - ref).abs().max() / ref.abs().max())
        if row == 7 and f"row1_{reduce}" in outputs:
            record["row1_bits"] = torch.equal(first[0].cpu(), outputs[f"row1_{reduce}"][0])
            from notorch_tpu_torch.kernels import dense_mpnn

            if hasattr(dense_mpnn, "dbuf_groups"):  # trees from before row 7's redesign have none
                record["launch"] = dense_mpnn.dbuf_groups(*block_shape.values())
        if saved is not None and key in saved:
            record["parent_bits"] = len(saved[key]) == len(first) and all(
                torch.equal(p.cpu(), q) for p, q in zip(first, saved[key]))
        if row in (7, "7b"):
            stamps = dbuf_stamps(call, block_shape)
            if stamps is not None:
                record["stamps_us"] = stamps
        if reduce == "sum":
            t = smoke.time_ms(call)
            breakdown = smoke.kernels_of_calls(call)
            record.update(ms=t["device"], eager_ms=t["eager"], stages_ms={
                stage: sum(k["ms"] for k in breakdown if any(f in k["name"] for f in frags)) / 5
                for stage, frags in STAGES.items()}, kernels_of_5_calls=breakdown)
        print(json.dumps(record), flush=True)
    if bits_path is not None and saved is None:
        bits_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, bits_path)
    if args.e2e:
        cfg = smoke.train_config(smoke.lipo_csv(tmp, smoke.TRAIN_MOLS), None,
                                 smoke.declarative_model_cfg(d, depth))
        state = smoke.prepare(cfg)
        loader = state["train_loader"]
        smoke.fit(state["model"], loader, epochs=2)  # fills the featurization cache, warms up
        epoch = smoke.profile_busy(lambda: smoke.fit(state["model"], loader, epochs=1), top=40, width=160)
        steps = len(loader)
        row5 = sum(k["ms"] for k in epoch["top"] if any(f in k["name"] for f in FWD_KERNELS))
        print(json.dumps({**tag, "declarative_steps": steps,
                          "profiled_step_device_ms": epoch["device_busy_ms"] / steps,
                          "profiled_step_row5_ms": row5 / steps,
                          "profiled_step_wall_ms": epoch["wall_ms"] / steps,
                          "profiled_step_busy_share": epoch["device_busy_share"]}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
