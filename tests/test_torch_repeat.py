"""Runs repeat bit for bit: ``chip_smoke.py``'s repeat check (REPEAT_STEPS
train steps of a path's model on its first training batches, twice from the
same weights; every parameter and every Adam state tensor must come out with
the same bits). On the CPU at 8 threads, at hidden width 32, over every
path whose glue gathers or sums (``x[idx]``'s backward adds by float atomics
across threads there; ``take``'s and ``index_add``'s add in a fixed order);
on the card at full width over the thirteen paths of ``chip_smoke.py``'s
repeat phase, where ``index_add_``, ``index_select``'s backward and
``torch.gather``'s backward add by float atomics and the port's
``segment_sum`` and ``take`` sum through TPU kernel row 8 in a fixed order.
This file imports no JAX, so that the card's cases also run where JAX is not
installed::

    python -m pytest --noconftest -m gpu tests/test_torch_repeat.py -q
"""

import pytest
import torch

import chip_smoke

# the declarative GVP model's rows 14-15 run their plain versions here, a
# minute for three steps: their bits twice are tests/test_torch_gvp_drift.py's
CPU_PATHS = ("flat", "impl_csr", "flat_gat", "gvp_recipe", "recipe", "declarative", "declarative_attention",
             "classification", "multicomponent", "schnet", "dropout", "bf16_block", "bf16_transformer", "bf16_csr")


@pytest.mark.parametrize("path", CPU_PATHS)
def test_cpu_runs_repeat_bit_for_bit(path, tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        record = chip_smoke.repeat_run(path, tmp_path, "cpu", d=32, batch=32)
    finally:
        torch.set_num_threads(threads)
    assert record["steps"] == chip_smoke.REPEAT_STEPS
    assert record["differ"] == [], record


@pytest.mark.gpu
@pytest.mark.parametrize("path", chip_smoke.REPEAT_PATHS)
def test_card_runs_repeat_bit_for_bit(path, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's paths run their kernels there")
    torch.backends.cuda.matmul.allow_tf32 = False
    record = chip_smoke.repeat_run(path, tmp_path, "cuda")
    assert record["steps"] == chip_smoke.REPEAT_STEPS
    assert record["differ"] == [], record
