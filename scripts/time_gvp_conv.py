"""Time TPU kernel rows 14-15 of a checkout on the card: the fused GVP
message convolution's forward and recompute backward at the GVP model's
first training batch (N = 1,216 nodes, K = 16, ds 256, dv 32, nb 16), as
``chip_smoke.py``'s time phase does (``time_gvp``: device ms a call from a
CUDA graph of 20 calls, a ``torch.profiler`` breakdown by stage, the
scratch); with ``--e2e``, also the declarative GVP model's warm training
step (ms a step of the second and third epochs of a 3-epoch ``fit``) and
its request of 512 clouds (4 in a row), as ``chip_smoke.py``'s GVP phases
run them, on the host's clock; then a fourth epoch and a fifth request
under ``torch.profiler``: the card's busy milliseconds a step and a
request, and their share of the wall time.

    python3 scripts/time_gvp_conv.py [--root DIR] [--e2e]

``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one); its ``csrc/gvp_conv.cu`` is built there at first use. The inputs and
the timing are this checkout's, so two trees, for example a parent commit
unpacked with ``git archive``, are timed the same way in one call on one
card. Prints one JSON line a kernel, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE), help="the checkout whose kernels run")
    parser.add_argument("--e2e", action="store_true", help="also time a warm training step and request")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("no CUDA device is available; this script times kernels on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    train, val = smoke.gvp_data()
    x = smoke.gvp_kernel_inputs(train[0]["inputs.P"], smoke.SEED + 50)
    for fn in (smoke.fused_gvp_conv_fwd, smoke.fused_gvp_conv_bwd):
        t, breakdown, stages, scratch_mb = smoke.time_gvp(fn, x)
        print(json.dumps({"root": args.root, "kernel": fn.__name__, "package": smoke.gvp_conv.__file__,
                          "N": x["N"], "live_rows": x["live_rows"], "ms": t["device"], "eager_ms": t["eager"],
                          "stages_ms": stages, "scratch_mb": scratch_mb, "kernels_of_5_calls": breakdown}),
              flush=True)
    if args.e2e:
        model = smoke.gvp_model(smoke.declarative_gvp_model_cfg(), "cuda")
        history = smoke.fit(model, train, val, epochs=3).history
        requests = []
        for _rep in range(4):
            t0 = time.perf_counter()
            smoke.predict(model, train, keys=["ffn.preds"])
            torch.cuda.synchronize()
            requests.append(time.perf_counter() - t0)
        epoch = smoke.profile_busy(lambda: smoke.fit(model, train, epochs=1))
        request = smoke.profile_busy(lambda: smoke.predict(model, train, keys=["ffn.preds"]))
        print(json.dumps({"root": args.root,
                          "warm_epochs_ms_per_step": [h["time"] * 1e3 / len(train) for h in history[1:]],
                          "request_s": requests, "clouds": len(train) * smoke.BATCH,
                          "profiled_step_device_ms": epoch["device_busy_ms"] / len(train),
                          "profiled_step_busy_share": epoch["device_busy_share"],
                          "profiled_request_device_ms": request["device_busy_ms"],
                          "profiled_request_busy_share": request["device_busy_share"]}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
