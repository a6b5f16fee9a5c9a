"""Time TPU kernel rows 8 and 9 of a checkout on the card: the row-pointer
segment sum (row 8, ``csr_segment_sum``) and the packed one (row 9,
``csr_segment_sum_packed``, every E->V reduce of ``model.impl: csr``) at
the first flat lipo batch (V = 2048, E = 4,096, d = 256), as
``chip_smoke.py``'s time phase does: device ms a call from a CUDA graph of
20 calls, beside the plain version's, the library call's and the bound.
Each row runs twice on that batch and on ``chip_smoke.py``'s random case
(over-full and empty nodes) and says whether the two calls gave the same
bits and whether they are the CPU plain version's bits; row 8 also with the
padding sink's run cut (``ms_without_sink``). Row 9 is timed as
the flat block calls it (``dst`` and ``edge_mask`` given) and, as
``ms_without_dst_and_mask``, without them, as ``chip_smoke.py``'s time
phase called it before this script (the wrappers of that time made a zero
``dst`` and mask for the backward on every call). In a tree that has it,
row 9b (the packed sum on bf16 data) follows row 9 on the same cases cast
to bf16 and on ``chip_smoke.py``'s cases whose runs straddle the 128-slot
chunks, bounded at bf16's bytes. Then row 8 at the shapes
the main path gives it (``chip_smoke.py`` ``glue_inputs``: the packed
training batch's node scatter and PackedMean's sum and count, each with its
longest run): the kernel on the rows in sorted order, in every tree whose
row 8 takes the width (``ms``), and, in a tree that has them, the kernel
reading the rows through the order (``through_order_ms``) and
``nn/ops.py`` ``segment_sum`` as the glue calls it, the sort included
(``segment_sum_eager_ms``, launched one by one). Then row 8b (the glue's
ordered bf16 sums, ``segment_sum_in_order`` on bf16 rows) at the embedding
table's gradient that ``chip_smoke.py`` times (the dense first lipo batch's
21,504 type ids, a run of 9,513) and at one glue call of the bf16 ``impl:
csr`` run (the backward of the flat block's ``take(node_messages, G.src)``
on the first flat batch: 4,096 edge rows into 2,048 nodes): device ms, the
kernels a call launches (``kernels_a_call``, by name, from a profile),
bf16 ``index_add_``'s ms, the bytes bound and, in a tree that has the probe,
the chain floor (the longest run times one add's latency,
``chain_add_latency``), with the bits' ``sha256``, ``repeatable`` and
``cpu_plain_bits``. Last, the time of a launch
that writes the output alone (``fill_ms``).

    python3 scripts/time_csr_segment.py [--root DIR] [--define NAME=VALUE ...] [--stages] [--e2e]

``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one); its ``csrc/*.cu`` are built there at first use. ``--define
NAME=VALUE`` times a variant of that checkout: its package is copied to a
temporary directory with ``constexpr int NAME = ...`` set to VALUE in
``csrc/csr_segment.cu`` (for example ``kNodeWarps=8``). ``--stages``
builds such a copy with ``kStages = 1``, whose packed kernel (rows 9 and 9b)
stamps ``%globaltimer`` at its phase boundaries in block 0 (the index staged, the
first warp's run formed, its rows summed), and prints them in µs from the
block's start, with the span of all blocks; the row-pointer kernel of such a
build stamps every block (row pointers in, first window in, end: the median
and last block of each, and the block of the longest span), with and
without the sink's run. ``--e2e`` adds warm training epochs of the recipe
(configs/dmpnn_regression.yaml, whose glue sums through row 8) and of its
``model.impl: csr`` twin: milliseconds a step on the host's clock, and
under ``torch.profiler`` the card's busy milliseconds a step with row 8's
and the sorts' shares. The inputs and the timing are
this checkout's, so two trees, for example a parent commit unpacked with
``git archive``, are timed the same way in one call on one card. Prints
one JSON line a row, then the card's name and power limit.
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
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SOURCE = "csr_segment.cu"
# the packed kernel's stamps of a --stages build, in order (slot 0 is the start)
WARM_EPOCHS = 5  # epochs of --e2e timed on the host's clock
STAGES = ("staged", "indexed", "summed")


def variant(root: Path, defines: list[str], into: Path, source: str = SOURCE) -> Path:
    """A copy of ``root``'s package under ``into`` with each NAME=VALUE set
    in ``csrc/<source>``; returns the copy's root."""
    shutil.copytree(root / "notorch_tpu_torch", into / "notorch_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = into / "notorch_tpu_torch" / "csrc" / source
    text = cu.read_text()
    for item in defines:
        name, value = item.split("=", 1)
        text, n = re.subn(rf"constexpr int {re.escape(name)} = [^,;]+", f"constexpr int {name} = {value}", text)
        if n != 1:
            raise SystemExit(f"--define {item}: csrc/{source} has {n} definitions of {name}")
    cu.write_text(text)
    return into


def digest(t) -> str:
    import torch

    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def stage_stamps(lib, call) -> dict:
    """One call of ``call`` in a --stages build: block 0's stamps in µs from
    its start, and the span of all blocks."""
    import torch

    lib.csr_segment_stages_read.argtypes = [ctypes.c_void_p]
    slots = len(STAGES) + 1
    out = (ctypes.c_ulonglong * (slots + 2))()
    torch.cuda.synchronize()
    if lib.csr_segment_stages_reset() != 0:
        raise SystemExit("csr_segment_stages_reset failed")
    call()
    torch.cuda.synchronize()
    if lib.csr_segment_stages_read(out) != 0:
        raise SystemExit("csr_segment_stages_read failed")
    at = list(out)
    return {**{s: (t - at[0]) / 1e3 for s, t in zip(STAGES, at[1:slots])},
            "all_blocks": (at[slots + 1] - at[slots]) / 1e3}


def path_shape(smoke, csr_segment, name: str, data, ids, n: int) -> dict:
    """Row 8 of the tree at one of the main path's shapes: ``data`` summed
    over ``ids`` into ``n`` segments (``smoke``: this checkout's
    chip_smoke module)."""
    import torch

    width = data.shape[1] if data.dim() > 1 else 1
    sorted_ids, order = torch.sort(ids, stable=True)
    row_ptr = torch.searchsorted(sorted_ids, torch.arange(n + 1, device=ids.device), out_int32=True)
    rows = data.reshape(data.shape[0], width).index_select(0, order).contiguous()
    plain = torch.zeros(n, width).index_add_(0, ids.cpu(), data.reshape(-1, width).cpu())
    record = {"row": 8, "kernel": "csr_segment_sum", "case": name,
              "shape": {"rows": data.shape[0], "d": width, "segments": n,
                        "longest_run": int(torch.bincount(ids).max())},
              "bound_ms": smoke.bound(data.shape[0] * width, smoke.nbytes(data, order, row_ptr) + n * width * 4)[0]}
    if hasattr(csr_segment, "segment_sum_in_order"):  # any width, and through an order
        from notorch_tpu_torch.nn.ops import segment_sum

        def kernel():
            return csr_segment._rowptr_launch(rows, row_ptr, None, n)

        record["through_order_ms"] = smoke.time_ms(
            lambda: csr_segment.segment_sum_in_order(data, order, row_ptr, n))["device"]
        record["segment_sum_eager_ms"] = smoke._elapsed_ms(lambda: segment_sum(data, ids, n), 200)
    elif width % 4 == 0:  # an older tree: the kernel's own entry, rows 16-byte vectors
        lib = csr_segment._lib()

        def kernel():
            out = torch.empty(n, width, device=rows.device)
            lib.csr_segment_sum_rowptr_f32(rows.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), rows.shape[0],
                                           width, n, torch.cuda.current_stream().cuda_stream)
            return out
    else:
        return {**record, "ms": None, "note": "this tree's row 8 takes d a multiple of 4 only"}
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    record.update(ms=smoke.time_ms(kernel)["device"], repeatable=bool(torch.equal(first, second)),
                  cpu_plain_bits=bool(torch.equal(first.cpu(), plain)))
    return record


def row8b_record(smoke, csr_segment, name: str, data, ids, n: int, chain: dict | None) -> dict:
    """Row 8b of the tree on ``data`` (bf16, CPU) summed over ``ids`` into
    ``n`` segments through their stable sort, as the glue calls it;
    ``chain``: this card's chain step (``chain_add_latency``) or None."""
    import torch

    d = data.shape[1]
    x, on_card = data.cuda(), ids.cuda()
    order, row_ptr = csr_segment.sorted_segments(on_card, n)

    def kernel():
        return csr_segment.segment_sum_in_order(x, order, row_ptr, n)

    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    plain = csr_segment.segment_sum_in_order_reference(data, order.cpu(), row_ptr.cpu(), n)
    t = smoke.time_ms(kernel)
    library = smoke.time_ms(lambda: torch.zeros(n, d, dtype=torch.bfloat16, device="cuda").index_add_(0, on_card, x))
    kernels = smoke.kernels_of_calls(kernel)
    longest = int(torch.bincount(ids, minlength=n).max())
    return {"row": "8b", "kernel": "csr_segment_sum_bf16", "case": name,
            "shape": {"rows": ids.numel(), "d": d, "segments": n, "longest_run": longest},
            "ms": t["device"], "eager_ms": t["eager"], "library_ms": library["device"],
            "library_note": "torch.zeros(segments, d, bf16).index_add_: one rounding, atomics in no fixed order",
            "bytes_bound_ms": smoke.bound_bf16(ids.numel() * d, smoke.nbytes(x, order, row_ptr) + n * d * 2)[0],
            "chain_floor_ms": None if chain is None else longest * chain["ns_per_add"] * 1e-6,
            "launches_a_call": sum(k["count"] for k in kernels) / 5,
            "kernels_a_call": [{**k, "ms": k["ms"] / 5, "count": k["count"] / 5} for k in kernels],
            "sha256": digest(first), "repeatable": bool(torch.equal(first, second)),
            "cpu_plain_bits": bool(torch.equal(first.cpu(), plain))}


def rowptr_stamps(lib, call, blocks: int) -> dict:
    """One call of row 8 in a --stages build: every block's stamps in µs from
    the earliest block start (the median and the last of each phase: row
    pointers in, first window in, end), and those of the block with the
    longest span."""
    import torch

    lib.csr_segment_rowptr_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    blocks = min(blocks, 4096)
    out = (ctypes.c_ulonglong * (5 * blocks))()
    torch.cuda.synchronize()
    if lib.csr_segment_rowptr_stamps_reset() != 0:
        raise SystemExit("csr_segment_rowptr_stamps_reset failed")
    call()
    torch.cuda.synchronize()
    if lib.csr_segment_rowptr_stamps_read(out, blocks) != 0:
        raise SystemExit("csr_segment_rowptr_stamps_read failed")
    rows = [list(out[5 * b: 5 * b + 5]) for b in range(blocks)]
    rows = [r for r in rows if r[0]]
    t0 = min(r[0] for r in rows)
    phases = {}
    for i, name in ((1, "pointers"), (2, "first_window"), (3, "end")):
        at = sorted((r[i] - t0) / 1e3 for r in rows if r[i])
        phases[name] = {"median": at[len(at) // 2], "last": at[-1]} if at else None
    longest = max(rows, key=lambda r: r[4])
    return {"blocks": len(rows), "phases_us": phases, "last_start_us": (max(r[0] for r in rows) - t0) / 1e3,
            "longest_span": {"rows": longest[4], **{name: (longest[i] - t0) / 1e3 if longest[i] else None
                                                     for i, name in ((0, "start"), (1, "pointers"),
                                                                     (2, "first_window"), (3, "end"))}}}


def warm_epoch(smoke, tmp: Path, name: str, model: dict) -> dict:
    """Warm training epochs of ``model`` on chip_smoke.py's 1,024 molecules:
    milliseconds a step on the host's clock (WARM_EPOCHS epochs, each timed,
    and their median), then one more epoch under torch.profiler: the card's
    busy milliseconds a step, row 8's share (``rowptr_kernel``) and that of
    the sorts and searches around it, and the busy share."""
    import torch

    cfg = smoke.train_config(smoke.lipo_csv(tmp, smoke.TRAIN_MOLS), None, model)
    state = smoke.prepare(cfg)
    loader = state["train_loader"]
    smoke.fit(state["model"], loader, epochs=2)  # fills the featurization cache, warms up
    torch.cuda.synchronize()
    steps = len(loader)
    walls = []
    for _ in range(WARM_EPOCHS):
        t0 = time.perf_counter()
        smoke.fit(state["model"], loader, epochs=1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    epoch = smoke.profile_busy(lambda: smoke.fit(state["model"], loader, epochs=1), top=60, width=160)

    def share(*fragments):
        return sum(k["ms"] for k in epoch["top"] if any(f in k["name"] for f in fragments)) / steps

    return {"e2e": name, "steps": steps, "warm_ms_per_step": sorted(walls)[len(walls) // 2],
            "warm_epochs_ms_per_step": walls,
            "profiled_step_wall_ms": epoch["wall_ms"] / steps,
            "profiled_step_device_ms": epoch["device_busy_ms"] / steps,
            "profiled_step_row8_ms": share("rowptr_kernel"),
            "profiled_step_sort_ms": share("sort", "Sort", "searchsorted", "radix"),
            "profiled_step_busy_share": epoch["device_busy_share"]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE), help="the checkout whose kernels run")
    parser.add_argument("--define", action="append", default=[], help=f"NAME=VALUE in csrc/{SOURCE}")
    parser.add_argument("--stages", action="store_true", help="stamp the packed kernel's phases (kStages = 1)")
    parser.add_argument("--e2e", action="store_true", help="also time warm epochs of the recipe and impl: csr")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix="time_csr_segment_") as tmp:
        root = Path(args.root).resolve()
        defines = args.define + (["kStages=1"] if args.stages else [])
        if defines:
            root = variant(root, defines, Path(tmp) / "variant")
        run(args, root, Path(tmp))


def run(args, root: Path, tmp: Path) -> None:
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from notorch_tpu_torch.kernels import csr_segment

    if not torch.cuda.is_available():
        smoke.fail("no CUDA device is available; this script times kernels on a GPU")
    d = smoke.MODEL_CFG["hidden_dim"]
    tag = {"root": args.root, **({"define": args.define} if args.define else {}),
           **({"stages": True} if args.stages else {})}
    csv_path = smoke.lipo_csv(tmp, smoke.N_MOLS)
    ds = smoke.build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
    G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH, layout="flat", csr_pack=True)))["inputs.G"]
    cases = {"lipo_first_flat_batch": smoke.flat_inputs(G, d, smoke.SEED + 5),
             "random_empty_and_overfull": smoke.random_flat_inputs(d, smoke.SEED + 6)}
    lib = csr_segment._lib()
    if args.stages and lib.csr_segment_stages_built() != 1:
        raise SystemExit("--stages: the build does not stamp")
    x, V = cases["lipo_first_flat_batch"], G.num_nodes
    n_real = int(x["edge_mask"].sum())

    def packed(x, V):  # as the flat block calls it, dst and mask given
        return csr_segment.csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V, dst=x["dst"],
                                                  edge_mask=x["edge_mask"])

    def packed_plain(x, V):
        return csr_segment.csr_segment_sum_packed_reference(x["data"], x["perm"], x["packed_dst"], V)

    def rowptr(x, V):
        return csr_segment.csr_segment_sum(x["sorted_data"], x["sorted_dst"], x["row_ptr"], V)

    def rowptr_plain(x, V):
        return csr_segment.csr_segment_sum_reference(x["sorted_data"], x["row_ptr"], V)

    def packed_bf16_plain(x, V):
        return csr_segment.csr_segment_sum_packed_bf16_reference(x["data"], x["perm"], x["packed_dst"], V)

    # (row, name, kernel, plain version, library call, operations, bytes, bound,
    # the timed inputs, the checked cases), the timed inputs the first flat batch's
    rows = [
        (9, "csr_segment_sum_packed", packed, packed_plain, smoke.library_index_add(x), n_real * d,
         n_real * d * 4 + smoke.nbytes(x["perm"], x["packed_dst"]) + V * d * 4, smoke.bound, x, cases),
        (8, "csr_segment_sum", rowptr, rowptr_plain, smoke.library_segment_reduce(x), G.num_edges * d,
         smoke.nbytes(x["sorted_data"], x["row_ptr"]) + V * d * 4, smoke.bound, x, cases),
    ]
    if hasattr(csr_segment, "csr_segment_sum_packed_bf16_reference"):  # row 9b: the messages in bf16
        cases_9b = {**cases, **{case: smoke.chunk_flat_inputs(case, d, smoke.SEED + 8 + i)
                                for i, case in enumerate(smoke.CHUNK_CASES)}}
        cases_9b = {case: {**cx, "data": cx["data"].bfloat16()} for case, cx in cases_9b.items()}
        xb = cases_9b["lipo_first_flat_batch"]
        rows.insert(1, ("9b", "csr_segment_sum_packed_bf16", packed, packed_bf16_plain,
                        smoke.library_index_add(xb), n_real * d,
                        n_real * d * 2 + smoke.nbytes(x["perm"], x["packed_dst"]) + V * d * 2, smoke.bound_bf16,
                        xb, cases_9b))
    for row, name, kernel, plain, library, ops, n_bytes, bound, x_row, row_cases in rows:
        checks = {}
        for case, cx in row_cases.items():
            cV = cx["row_ptr"].shape[0] - 1
            first, second = kernel(cx, cV), kernel(cx, cV)
            torch.cuda.synchronize()
            cpu = plain({k: v.cpu() for k, v in cx.items()}, cV)
            checks[case] = {"sha256": digest(first), "repeatable": bool(torch.equal(first, second)),
                            "cpu_plain_bits": bool(torch.equal(first.cpu(), cpu))}
        t, plain_t, library_t = (smoke.time_ms(lambda: kernel(x_row, V)), smoke.time_ms(lambda: plain(x_row, V)),
                                 smoke.time_ms(library))
        bound_ms, bound_by = bound(ops, n_bytes)
        record = {**tag, "row": row, "kernel": name,
                  "shape": {"V": V, "E": G.num_edges, "d": d, "real_edges": n_real,
                            "budget": x["perm"].shape[0] // (V // 128)},
                  "ms": t["device"], "eager_ms": t["eager"], "plain_ms": plain_t["device"],
                  "library_ms": library_t["device"], "bound_ms": bound_ms, "bound_by": bound_by,
                  "checks": checks}
        if row == 9:  # as chip_smoke.py's time phase once called it: no dst, no mask
            record["ms_without_dst_and_mask"] = smoke.time_ms(
                lambda: csr_segment.csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V))["device"]
        if row == 8:  # the padding sink's run cut (row pointers clipped at the last real edge)
            cut = {**x, "row_ptr": torch.clamp(x["row_ptr"], max=n_real)}
            record["longest_run"] = int(torch.diff(x["row_ptr"]).max())
            record["ms_without_sink"] = smoke.time_ms(lambda: kernel(cut, V))["device"]
            if args.stages and hasattr(lib, "csr_segment_rowptr_stamps_read"):
                record["stages_us"] = {"with_sink": rowptr_stamps(lib, lambda: kernel(x, V), 4096),
                                       "without_sink": rowptr_stamps(lib, lambda: kernel(cut, V), 4096)}
        if args.stages and row in (9, "9b"):
            record["stages_us"] = stage_stamps(lib, lambda: kernel(x_row, V))
        print(json.dumps(record), flush=True)
    main_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH)))["inputs.G"]
    for name, (data, ids, n) in smoke.glue_inputs(main_G, d, smoke.SEED + 7).items():
        print(json.dumps({**tag, **path_shape(smoke, csr_segment, name, data, ids, n)}), flush=True)
    if hasattr(csr_segment, "bf16_chain_sum_reference"):  # row 8b
        chain = csr_segment.chain_add_latency() if hasattr(csr_segment, "chain_add_latency") else None
        if chain is not None:
            print(json.dumps({**tag, "chain_add": chain}), flush=True)
        dense_G = next(iter(smoke.DataLoader(ds, batch_size=smoke.BATCH, layout="dense")))["inputs.G"]
        rng = np.random.default_rng(smoke.SEED + 61)
        flat_src = torch.as_tensor(np.asarray(G.src)).long()
        cases_8b = {"table_gradient": smoke.table_gradient(dense_G, d),
                    "csr_take_backward": (torch.from_numpy(rng.standard_normal((flat_src.numel(), d))
                                                           .astype(np.float32)).bfloat16(), flat_src, V)}
        for name, (data, ids, n) in cases_8b.items():
            print(json.dumps({**tag, **row8b_record(smoke, csr_segment, name, data, ids, n, chain)}), flush=True)
    if args.e2e:
        for name, model in (("recipe", dict(smoke.MODEL_CFG)), ("impl_csr", {**smoke.MODEL_CFG, "impl": "csr"})):
            print(json.dumps({**tag, **warm_epoch(smoke, tmp, name, model)}), flush=True)
    # a launch that only writes what rows 8-9 write, timed the same way: the
    # floor a kernel of this output pays in a graph of 20 calls
    print(json.dumps({**tag, "fill_ms": smoke.time_ms(lambda: torch.zeros(V, d, device="cuda"))["device"],
                      "fill_note": "torch.zeros([V, d]): one launch writing the output alone"}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
