"""Row 8b's arithmetic on the CPU: one step of its chain and its plain
version against JAX.

The card's row 8b (``csrc/csr_segment.cu`` ``rowptr_kernel_bf16``) adds a
bf16 pair to its running sum with one packed bf16 add, a single rounding of
the exact sum. XLA's bf16 scatter-add, and the plain version
(``bf16_chain_sum_reference``), add in f32 and round the f32 sum to bf16.
The two agree for every pair of bf16 values that is not NaN: pinned here
over ``chip_smoke.BF16_PAIR_CLASSES`` (random values, exponent gaps of
14-20 and of 100 binades, exact ties, subnormals, signed zeros and
infinities), each pair's exact sum rounded once (``fractions``) against the
f32 add rounded to bf16 and against ``jnp.add`` on bf16 (which XLA's CPU
computes with subnormals flushed to zero: the port keeps them, so on
subnormals alone the two differ). The plain version
is held to ``jax.ops.segment_sum``'s bits on the embedding table's gradient
that ``chip_smoke.py`` times (the dense first lipo batch's type ids, one run
of 9,513 rows), the longest chain of the main path. Bits are compared
throughout: no tolerance.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from notorch_tpu_torch.kernels.csr_segment import bf16_chain_sum_reference, sorted_segments

PAIRS = 2048  # pairs a class


def bf16_value(bits: int) -> Fraction:
    """The exact value of finite bf16 bits."""
    sign = -1 if bits & 0x8000 else 1
    exp, mant = bits >> 7 & 0xFF, bits & 0x7F
    if exp == 0:
        return sign * Fraction(mant, 2 ** 133)
    return sign * (128 + mant) * Fraction(2) ** (exp - 134)


def round_once(q: Fraction) -> int:
    """Nonzero finite ``q`` rounded once to the nearest bf16, ties to even,
    as bits (an infinity past the largest)."""
    sign = 0x8000 if q < 0 else 0
    q = abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    while Fraction(2) ** e > q:
        e -= 1
    while Fraction(2) ** (e + 1) <= q:
        e += 1
    e = max(e, -126)
    m = q / Fraction(2) ** (e - 7)
    whole = m.numerator // m.denominator
    rest = m - whole
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2):
        whole += 1
    if whole == 256:
        whole, e = 128, e + 1
    if e > 127:
        return sign | 0x7F80
    if whole < 128:  # subnormal: e is -126
        return sign | whole
    return sign | (e + 127) << 7 | (whole - 128)


def exact_sum_bits(a: int, b: int) -> int:
    """a + b for bf16 bits (never +inf with -inf), the exact sum rounded once:
    an infinity keeps its sign, an exact zero is -0 only from -0 + -0."""
    for x in (a, b):
        if x & 0x7FFF == 0x7F80:
            return x
    q = bf16_value(a) + bf16_value(b)
    if q == 0:
        return 0x8000 if a == b == 0x8000 else 0
    return round_once(q)


def as_bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def bits_of(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("kind", chip_smoke.BF16_PAIR_CLASSES)
def test_f32_add_rounded_to_bf16_is_the_exact_sum_rounded_once(kind):
    """The f32 sum of two bf16 values rounded to bf16 (what the plain version
    adds) is their exact sum rounded once (what add.rn.bf16x2 gives)."""
    a, b = chip_smoke.bf16_pairs(kind, PAIRS, seed=11)
    got = bits_of((as_bf16(a).float() + as_bf16(b).float()).bfloat16())
    want = np.array([exact_sum_bits(int(x), int(y)) for x, y in zip(a, b)], np.uint16)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, [(hex(a[i]), hex(b[i]), hex(got[i]), hex(want[i])) for i in bad[:5]]


def flushed_sum_bits(a: int, b: int) -> int:
    """``exact_sum_bits`` with subnormal inputs and a subnormal result taken
    as zero of their sign: XLA's CPU arithmetic, which runs with denormals
    flushed."""
    def flush(x: int) -> int:
        return x & 0x8000 if x & 0x7F80 == 0 else x

    return flush(exact_sum_bits(flush(a), flush(b)))


@pytest.mark.parametrize("kind", chip_smoke.BF16_PAIR_CLASSES)
def test_bf16_add_gives_jax_bits(kind):
    """``jnp.add`` on bf16 arrays (XLA on the CPU) is the exact sum rounded
    once, with subnormals flushed to zero; ``torch``'s bf16 add on the CPU
    (the plain version's step, and the card's) gives the same bits on every
    class but the subnormals, which it keeps."""
    a, b = chip_smoke.bf16_pairs(kind, PAIRS, seed=12)
    got = bits_of(as_bf16(a) + as_bf16(b))
    ja, jb = (jax.lax.bitcast_convert_type(jnp.asarray(x.view(np.int16)), jnp.bfloat16) for x in (a, b))
    jax_bits = np.asarray(jax.lax.bitcast_convert_type(jnp.add(ja, jb), jnp.int16)).view(np.uint16)
    flushed = np.array([flushed_sum_bits(int(x), int(y)) for x, y in zip(a, b)], np.uint16)
    bad = np.flatnonzero(jax_bits != flushed)
    assert bad.size == 0, [(hex(a[i]), hex(b[i]), hex(jax_bits[i]), hex(flushed[i])) for i in bad[:5]]
    if kind == "subnormal":
        assert not np.array_equal(got, jax_bits)  # the port keeps what XLA's CPU flushes
    else:
        bad = np.flatnonzero(got != jax_bits)
        assert bad.size == 0, [(hex(a[i]), hex(b[i]), hex(got[i]), hex(jax_bits[i])) for i in bad[:5]]


@pytest.mark.parametrize("kind", chip_smoke.BF16_PAIR_CLASSES)
def test_chain_of_pairs_is_one_rounding_each(kind):
    """The plain version on pairs (segments of two rows, as ``chip_smoke.py``
    feeds the kernel): 0 + a + b is a + b rounded once, each column."""
    a, b = chip_smoke.bf16_pairs(kind, PAIRS, seed=13)
    data, ids, m = chip_smoke.bf16_pair_rows(a, b, 8)
    order, row_ptr = sorted_segments(ids, m)
    got = bits_of(bf16_chain_sum_reference(data.index_select(0, order), row_ptr, m)).reshape(-1)
    want = np.array([exact_sum_bits(int(x), int(y)) for x, y in zip(a[: 8 * m], b[: 8 * m])], np.uint16)
    # +0 + -0 is +0: the chain starts from +0, so a -0 in a leaves b as it is
    zero_a = (a[: 8 * m] & 0x7FFF) == 0
    want[zero_a] = np.where((b[: 8 * m][zero_a] & 0x7FFF) == 0, 0, b[: 8 * m][zero_a])
    assert np.array_equal(got, want)


def table_gradient(d: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``chip_smoke.table_gradient`` on the dense first lipo batch (64
    molecules): the embedding table's gradient that ``chip_smoke.py`` times
    row 8b on."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="bf16_chain_") as tmp:
        csv_path = chip_smoke.lipo_csv(Path(tmp), chip_smoke.BATCH)
        ds = chip_smoke.build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
        G = next(iter(chip_smoke.DataLoader(ds, batch_size=chip_smoke.BATCH, layout="dense")))["inputs.G"]
    return chip_smoke.table_gradient(G, d)


@pytest.mark.parametrize("d", [256, 3])
def test_chain_sum_gives_segment_sum_bits_on_the_table_gradient(d):
    """``bf16_chain_sum_reference`` over the stable sort of the ids gives
    ``jax.ops.segment_sum``'s bits (XLA's bf16 scatter-add) on the table
    gradient whose longest run, 9,513 rows, is row 8b's longest chain."""
    data, ids, n = table_gradient(d)
    assert ids.numel() == 21504 and int(torch.bincount(ids).max()) >= 4096
    order, row_ptr = sorted_segments(ids, n)
    got = bf16_chain_sum_reference(data.index_select(0, order), row_ptr, n)
    jdata = jax.lax.bitcast_convert_type(jnp.asarray(data.view(torch.int16).numpy()), jnp.bfloat16)
    want = jax.ops.segment_sum(jdata, jnp.asarray(ids.numpy()), num_segments=n)
    want_bits = np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16)).view(np.uint16)
    assert np.array_equal(bits_of(got), want_bits)
