"""Time TPU kernel rows 8 and 9 of a checkout on the card: the row-pointer
segment sum (row 8, ``csr_segment_sum``) and the packed one (row 9,
``csr_segment_sum_packed``, every E->V reduce of ``model.impl: csr``) at
the first flat lipo batch (V = 2048, E = 4,096, d = 256), as
``chip_smoke.py``'s time phase does: device ms a call from a CUDA graph of
20 calls, beside the plain version's, the library call's and the bound.
Each row runs twice on that batch and on ``chip_smoke.py``'s random case
(over-full and empty nodes) and says whether the two calls gave the same
bits and whether they are the CPU plain version's bits. Row 9 is timed as
the flat block calls it (``dst`` and ``edge_mask`` given) and, as
``ms_without_dst_and_mask``, without them, as ``chip_smoke.py``'s time
phase called it before this script (the wrappers of that time made a zero
``dst`` and mask for the backward on every call). Then the time of a launch
that writes the output alone (``fill_ms``).

    python3 scripts/time_csr_segment.py [--root DIR] [--define NAME=VALUE ...] [--stages]

``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one); its ``csrc/*.cu`` are built there at first use. ``--define
NAME=VALUE`` times a variant of that checkout: its package is copied to a
temporary directory with ``constexpr int NAME = ...`` set to VALUE in
``csrc/csr_segment.cu`` (for example ``kNodeWarps=8``). ``--stages``
builds such a copy with ``kStages = 1``, whose packed kernel stamps
``%globaltimer`` at its phase boundaries in block 0 (the index staged, the
first warp's run formed, its rows summed), and prints them in µs from the
block's start, with the span of all blocks. The inputs and the timing are
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
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCE = "csr_segment.cu"
# the packed kernel's stamps of a --stages build, in order (slot 0 is the start)
STAGES = ("staged", "indexed", "summed")


def variant(root: Path, defines: list[str], into: Path) -> Path:
    """A copy of ``root``'s package under ``into`` with each NAME=VALUE set
    in ``csrc/csr_segment.cu``; returns the copy's root."""
    shutil.copytree(root / "notorch_tpu_torch", into / "notorch_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = into / "notorch_tpu_torch" / "csrc" / SOURCE
    text = cu.read_text()
    for item in defines:
        name, value = item.split("=", 1)
        text, n = re.subn(rf"constexpr int {re.escape(name)} = [^,;]+", f"constexpr int {name} = {value}", text)
        if n != 1:
            raise SystemExit(f"--define {item}: csrc/{SOURCE} has {n} definitions of {name}")
    cu.write_text(text)
    return into


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE), help="the checkout whose kernels run")
    parser.add_argument("--define", action="append", default=[], help=f"NAME=VALUE in csrc/{SOURCE}")
    parser.add_argument("--stages", action="store_true", help="stamp the packed kernel's phases (kStages = 1)")
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

    # (row, name, kernel, plain version, library call, operations, bytes) at the first flat batch
    rows = [
        (9, "csr_segment_sum_packed", packed, packed_plain, smoke.library_index_add(x), n_real * d,
         n_real * d * 4 + smoke.nbytes(x["perm"], x["packed_dst"]) + V * d * 4),
        (8, "csr_segment_sum", rowptr, rowptr_plain, smoke.library_segment_reduce(x), G.num_edges * d,
         smoke.nbytes(x["sorted_data"], x["row_ptr"]) + V * d * 4),
    ]
    for row, name, kernel, plain, library, ops, n_bytes in rows:
        checks = {}
        for case, cx in cases.items():
            cV = cx["row_ptr"].shape[0] - 1
            first, second = kernel(cx, cV), kernel(cx, cV)
            torch.cuda.synchronize()
            cpu = plain({k: v.cpu() for k, v in cx.items()}, cV)
            checks[case] = {"sha256": digest(first), "repeatable": bool(torch.equal(first, second)),
                            "cpu_plain_bits": bool(torch.equal(first.cpu(), cpu))}
        t, plain_t, library_t = (smoke.time_ms(lambda: kernel(x, V)), smoke.time_ms(lambda: plain(x, V)),
                                 smoke.time_ms(library))
        bound_ms, bound_by = smoke.bound(ops, n_bytes)
        record = {**tag, "row": row, "kernel": name,
                  "shape": {"V": V, "E": G.num_edges, "d": d, "real_edges": n_real,
                            "budget": x["perm"].shape[0] // (V // 128)},
                  "ms": t["device"], "eager_ms": t["eager"], "plain_ms": plain_t["device"],
                  "library_ms": library_t["device"], "bound_ms": bound_ms, "bound_by": bound_by,
                  "checks": checks}
        if row == 9:  # as chip_smoke.py's time phase once called it: no dst, no mask
            record["ms_without_dst_and_mask"] = smoke.time_ms(
                lambda: csr_segment.csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V))["device"]
        if args.stages and row == 9:
            record["stages_us"] = stage_stamps(lib, lambda: kernel(x, V))
        print(json.dumps(record), flush=True)
    # a launch that only writes what rows 8-9 write, timed the same way: the
    # floor a kernel of this output pays in a graph of 20 calls
    print(json.dumps({**tag, "fill_ms": smoke.time_ms(lambda: torch.zeros(V, d, device="cuda"))["device"],
                      "fill_note": "torch.zeros([V, d]): one launch writing the output alone"}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
