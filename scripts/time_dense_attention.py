"""Time TPU kernel rows 10-13 of a checkout on the card: the attention core's
forward (rows 10 and 12) and recompute backward (rows 11 and 13) at the
graph transformer's first packed batch (16 bins, V = 128, E = 256) and the
per-molecule dense loader's first batch (B = 64, V = 48, E = 128, the
declarative graph transformer's), 4 heads of 64, edge bias on, as
``chip_smoke.py``'s time phase does: device ms a call from a CUDA graph of
20 calls, and a ``torch.profiler`` breakdown of 20 calls by kernel. Each
row runs twice and says whether the two calls gave the same bits, with a
digest of its outputs (rows that share a kernel share the digest). ``--bf16``
also runs rows 10b-13b the same way after the exact rows, in both bf16
modes: on bf16 inputs (``mode`` "bf16_inputs", a bf16 model's path) and with
``matmul_dtype="bfloat16"`` on the f32 inputs (``mode`` "mm").

    python3 scripts/time_dense_attention.py [--root DIR] [--bf16] [--define NAME=VALUE ...] [--stages] [--e2e] [--lockstep]

``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one); its ``csrc/*.cu`` are built there at first use. ``--define
NAME=VALUE`` times a variant of that checkout: its package is copied to a
temporary directory with ``constexpr int NAME = ...`` set to VALUE in
``csrc/dense_attention.cu`` (for example ``kMaxCluster=8``). ``--stages``
builds such a copy with ``kStages = 1``, whose kernels stamp
``%globaltimer`` at each phase boundary of block 0 (the gather, each pass,
each walk of a bf16 forward, the cluster barriers) and the earliest start
and latest end over all blocks, and prints them in microseconds from block 0's start, one call per
row and shape. ``--e2e`` adds a warm epoch of the declarative graph
transformer under ``torch.profiler``: the card's busy milliseconds a step
and rows 12-13's share of them. ``--lockstep`` runs that model's training
steps in lockstep, card against CPU, and prints each gradient's relative L2
distance. The inputs and the timing are this checkout's, so two trees, for
example a parent commit unpacked with ``git archive``, are timed the same
way in one call on one card. Prints one JSON line a row and shape, then the
card's name and power limit.
"""

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCE = Path("notorch_tpu_torch") / "csrc" / "dense_attention.cu"
# rows 12-13's kernels by name in a profile: this tree's, then the block per
# (bin, head) of the design before their redesign for Hopper
ROW_KERNELS = {12: ("attn_rows_kernel<false", "attn_kernel<false"),
               13: ("attn_cluster_kernel", "attn_kernel<true")}
# the stamps of each kernel of a --stages build, by slot ("loaded": the
# gather's first lanes read and counted; "sorted": the block's lists built;
# a bf16 forward's "first_walk" and "second_walk": the end of each walk over
# the row's pairs, stamped in slots after "done" and only by the bf16
# modes), and row 13's latest block of bin 0's cluster at its start and each
# pass's end; a slot the kernel does not stamp is left out
STAGES = {"forward": ("start", "loaded", "sorted", "done", "first_walk", "second_walk"),
          "query_pass": ("start", "loaded", "sorted", "done"),
          "key_pass": ("start", "loaded", "sorted", "done"),
          "cluster": ("start", "loaded", "sorted", "query_pass_done", "cluster_barrier", "key_pass_done", "end",
                      "cluster0_last_start", "cluster0_last_query_pass_done", "cluster0_last_key_pass_done")}
SLOTS = 10  # kStageSlots of csrc/dense_attention.cu


def variant(root: Path, defines: list[str], into: Path) -> Path:
    """A copy of ``root``'s package under ``into`` with each NAME=VALUE set
    in ``csrc/dense_attention.cu``; returns the copy's root."""
    shutil.copytree(root / "notorch_tpu_torch", into / "notorch_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = into / SOURCE
    text = cu.read_text()
    for item in defines:
        name, value = item.split("=", 1)
        text, n = re.subn(rf"constexpr int {re.escape(name)} = [^,;]+", f"constexpr int {name} = {value}", text)
        if n != 1:
            raise SystemExit(f"--define {item}: {SOURCE} has {n} definitions of {name}")
    cu.write_text(text)
    return into


def kernel_name(name: str) -> str:
    """``attn_rows_kernel<false, 2>`` of a profiler's demangled name."""
    found = re.search(r"(\w+<[^>]*>)\(", name)
    return found.group(1) if found else name


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
    parser.add_argument("--bf16", action="store_true", help="also rows 10b-13b in both bf16 modes")
    parser.add_argument("--define", action="append", default=[], help=f"NAME=VALUE in {SOURCE}")
    parser.add_argument("--stages", action="store_true", help="stamp each kernel's phases (kStages = 1)")
    parser.add_argument("--e2e", action="store_true", help="also profile a warm declarative attention epoch")
    parser.add_argument("--lockstep", action="store_true", help="also hold its steps card against CPU")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix="time_dense_attention_") as tmp:
        root = Path(args.root).resolve()
        defines = args.define + (["kStages=1"] if args.stages else [])
        if defines:
            root = variant(root, defines, Path(tmp) / "variant")
        run(args, root, Path(tmp))


def stage_stamps(kernels, lib, call) -> dict:
    """One call of ``call`` in a --stages build: each kernel's stamps in
    us from block 0's start, and its span over all blocks."""
    import torch

    lib.dense_attention_stages_read.argtypes = [ctypes.c_void_p]
    n = len(STAGES)
    out = (ctypes.c_ulonglong * (n * SLOTS + n * 2))()
    torch.cuda.synchronize()
    if lib.dense_attention_stages_reset() != 0:
        raise SystemExit("dense_attention_stages_reset failed")
    call()
    torch.cuda.synchronize()
    if lib.dense_attention_stages_read(out) != 0:
        raise SystemExit("dense_attention_stages_read failed")
    stamps = {}
    for k, (name, stages) in enumerate(STAGES.items()):
        if name not in kernels:
            continue
        at = [out[k * SLOTS + s] for s in range(len(stages))]
        start, end = out[n * SLOTS + 2 * k], out[n * SLOTS + 2 * k + 1]
        written = sorted((t, s) for s, t in zip(stages[1:], at[1:]) if t != 0)
        stamps[name] = {**{s: (t - at[0]) / 1e3 for t, s in written},
                        "span_all_blocks_us": (end - start) / 1e3,
                        "block0_start_after_first_us": (at[0] - start) / 1e3}
    return stamps


def cluster_occupancy(x, heads: int) -> dict | None:
    """Row 13's blocks a cluster at these inputs and how many such clusters
    the card holds at once (None for a tree without clusters)."""
    from notorch_tpu_torch.kernels import dense_attention

    lib = dense_attention._lib()
    (B, V, d), E = x[0].shape, x[4].shape[1]
    try:
        size = lib.dense_attention_cluster_blocks(V, E, heads, d // heads)
        active = lib.dense_attention_active_clusters(V, E, heads, d // heads)
    except AttributeError:
        return None
    return {"bins": B, "blocks_a_cluster": size, "clusters_at_once": active}


def run(args, root: Path, tmp: Path) -> None:
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("no CUDA device is available; this script times kernels on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = {"root": args.root, **({"define": args.define} if args.define else {}),
           **({"stages": True} if args.stages else {})}
    d, heads = smoke.MODEL_CFG["hidden_dim"], smoke.GT_CFG["num_heads"]
    csv_path = smoke.lipo_csv(tmp, smoke.N_MOLS)
    ds = smoke.build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
    packed_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH, **smoke.gat_loader_kwargs("dense_packed"))))
    dense_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH, layout="dense")))
    shapes = {"packed_first_batch": smoke.batch_attention_inputs(packed_G["inputs.G"], d, heads, smoke.SEED + 30),
              "dense_first_batch": smoke.batch_attention_inputs(dense_G["inputs.G"], d, heads, smoke.SEED + 32)}
    rows = {10: (smoke.fused_dense_attention_fwd, False), 11: (smoke.fused_dense_attention_bwd, True),
            12: (smoke.fused_dense_attention_fwd_v2, False), 13: (smoke.fused_dense_attention_bwd_v2, True)}
    if args.stages:
        from notorch_tpu_torch.kernels import dense_attention

        lib = dense_attention._lib()
        if lib.dense_attention_stages_built() != 1:
            raise SystemExit("--stages: the build does not stamp")
    # (the exact rows, then with --bf16 each row on bf16 inputs and with
    # matmul_dtype, bounded as chip_smoke.py bounds the bf16 rows)
    modes = [("exact", None, {}, smoke.bound)]
    if args.bf16:
        modes += [("bf16_inputs", torch.bfloat16, {}, smoke.bound_bf16),
                  ("mm", None, {"matmul_dtype": "bfloat16"}, smoke.bound_bf16)]
    cases = [(mode, shape, x if dtype is None else [t.to(dtype) if t is not None and t.is_floating_point() else t
                                                    for t in x], kw, bound)
             for mode, dtype, kw, bound in modes for shape, x in shapes.items()]
    for mode, shape, x, kw, bound in cases:
        for row, (fn, bwd) in rows.items():
            def call(fn=fn, bwd=bwd, x=x, kw=kw):
                out = fn(*x[:7], x[7], num_heads=heads, **kw) if bwd else fn(*x[:7], num_heads=heads, **kw)
                return out if bwd else (out,)

            first, second = call(), call()
            torch.cuda.synchronize()
            ops, n_bytes, _ = smoke.attention_work(x, heads, bwd)
            bound_ms, bound_by = bound(ops, n_bytes)
            label = row if mode == "exact" else f"{row}b"
            record = {**tag, "row": label, **({} if mode == "exact" else {"mode": mode}), "shape": shape,
                      "sha256": digest(first),
                      "repeatable": all(torch.equal(p, q) for p, q in zip(first, second)),
                      "bound_ms": bound_ms, "bound_by": bound_by}
            if row == 13:
                record["clusters"] = cluster_occupancy(x, heads)
            if args.stages:
                kernels = ("forward",) if not bwd else ("query_pass", "key_pass") if row == 11 else ("cluster",)
                record["stages_us"] = stage_stamps(kernels, lib, call)
            else:
                t = smoke.time_ms(call)
                breakdown = smoke.kernels_of_calls(call, calls=20)
                record.update(ms=t["device"], eager_ms=t["eager"], bound_multiple=t["device"] / bound_ms,
                              kernels_ms_a_call={kernel_name(k["name"]): k["ms"] / 20 for k in breakdown},
                              kernels_of_20_calls=breakdown)
            print(json.dumps(record), flush=True)
    if args.e2e:
        cfg = smoke.train_config(smoke.lipo_csv(tmp, smoke.TRAIN_MOLS), None,
                                 smoke.declarative_attention_model_cfg(d, smoke.MODEL_CFG["depth"], heads))
        state = smoke.prepare(cfg)
        loader = state["train_loader"]
        smoke.fit(state["model"], loader, epochs=2)  # fills the featurization cache, warms up
        epoch = smoke.profile_busy(lambda: smoke.fit(state["model"], loader, epochs=1), top=60, width=160)
        steps = len(loader)
        share = {f"profiled_step_row{row}_ms": sum(k["ms"] for k in epoch["top"]
                                                   if any(f in k["name"] for f in frags)) / steps
                 for row, frags in ROW_KERNELS.items()}
        print(json.dumps({**tag, "declarative_attention_steps": steps,
                          "profiled_step_device_ms": epoch["device_busy_ms"] / steps, **share,
                          "profiled_step_wall_ms": epoch["wall_ms"] / steps,
                          "profiled_step_busy_share": epoch["device_busy_share"]}), flush=True)
    if args.lockstep:
        model = smoke.declarative_attention_model_cfg(d, smoke.MODEL_CFG["depth"], heads)
        cfg = smoke.train_config(smoke.lipo_csv(tmp, smoke.TRAIN_MOLS), None, model)
        print(json.dumps({**tag, "lockstep": smoke.lockstep(cfg, smoke.TRAIN_EPOCHS, "declarative attention")}),
              flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
