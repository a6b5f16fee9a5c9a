"""TPU kernel row 9b, the packed segment sum on bf16 data, and the flat
``impl: csr`` D-MPNN at ``dtype: bfloat16``, port against the JAX package
on the CPU (the JAX side runs its Pallas kernel with ``interpret=True``).

- Row 9b's plain version (``csr_segment_sum_packed_bf16_reference``)
  against JAX's ``csr_segment_sum_packed`` on bf16 messages: the first flat
  lipo batch of 64 molecules (V = 2048), a case whose nodes' runs straddle
  a 128-slot chunk boundary, and one whose runs span three chunks (and the
  straddling case at d = 12, where the kernel reads 8-byte vectors). The JAX
  kernel rounds each chunk's f32 partial to bf16 and each add of the
  partials to its bf16 output; the plain version rounds at the same
  points. Measured: JAX's bits on every element of every case (the f32
  partial of a chunk sums a few bf16 values, exactly in either order), so
  the cases are held bit for bit. The control: an f32 sum rounded once
  differs from JAX on the straddling case, so the comparison sees where the
  rounding happens.
- The wrapper on CPU tensors, its gradient (the masked gather), and
  ``ChempropBlock(impl="csr", dtype="bfloat16")`` against JAX's block:
  node and edge hiddens and every gradient, at the bf16 holds of
  ``tests/test_torch_bf16_models.py`` (the two packages sum the dense
  layers' products in other orders, so a value near a bf16 rounding
  boundary can land on the other side; the bias gradient, summed over
  every edge lane, at the block's largest gradient). Measured: every output
  and gradient JAX's bits but the stacked bias's, within 2.96e-3 of the
  block's largest gradient (JAX reduces it with a bf16 accumulator).
- The CLIs train and serve ``configs/dmpnn_regression.yaml`` with
  ``model.impl=csr model.dtype=bfloat16`` on the CPU. The port's raw model
  outputs have the bits of JAX's ``predict`` on the same packed batches
  (its Pallas kernel in interpret mode rounds every reduce as row 9b does),
  and lie within UNPACKED_ULPS bf16 ulps of JAX's on the unpacked batches
  its ``run_predict`` serves (there XLA's bf16 scatter-add rounds each add,
  the port's row 8b route, so a node that straddles a chunk rounds
  otherwise). The served, denormalized predictions agree with JAX's
  ``predict`` with the task transform at PRED_RTOL.
- The fused D-MPNN layouts at bf16: the JAX package raises ``ValueError``
  in its kernels (layer 0's f32 bias promotes the bf16 state, and the bf16
  store refuses it), the port ``NotImplementedError`` before it runs, on
  ``build_dmpnn`` and on a declarative ``FusedDenseChempropBlock`` after a
  bf16 embedding.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from notorch_tpu.cli import registry as jax_registry
from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.data import graph as jax_graph
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.kernels.csr_segment import csr_segment_sum_packed as jax_packed
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.tasks import transforms as jax_task_transforms
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_model
from notorch_tpu_torch.data import graph
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.kernels.csr_segment import (
    csr_segment_sum_packed,
    csr_segment_sum_packed_bf16_reference,
    pack_edges_by_tile,
)
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.nn.chemprop import ChempropBlock
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import predict, to_device
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES

from .test_torch_bf16_models import BIAS_GRAD_RTOL, GRAD_RTOL, PRED_RTOL
from .test_torch_flat_model import JAX_PIPE, PIPE, SMIS, _cli, _port_params
from .test_torch_gat import BATCH, D, N, datasets, lipo_csv  # noqa: F401 (fixtures)

BF16 = "bfloat16"


def bits(x) -> np.ndarray:
    """A bf16 array's values as float32 (exact), from JAX or torch."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_messages(E: int, d: int, seed: int) -> np.ndarray:
    """Seeded bf16-representable messages, as float32."""
    x = np.random.default_rng(seed).standard_normal((E, d)).astype(np.float32)
    return bits(torch.from_numpy(x).bfloat16())


def lipo_flat_case(datasets):  # noqa: F811
    """The first flat lipo batch of 64 molecules, packed (V = 2048)."""
    ds, _ = datasets
    G = next(iter(DataLoader(ds, batch_size=64, layout="flat", csr_pack=True)))["inputs.G"]
    return np.asarray(G.csr_perm), np.asarray(G.csr_dst), G.num_nodes, G.num_edges


def built_case(name: str):
    """``chip_smoke.py``'s cases whose runs cross chunk boundaries
    (``chunk_case_ids``: ``straddle``, runs across slot 128 in two tiles;
    ``three_chunks``, node 5's 300 in-edges over three chunks), packed."""
    dst = chip_smoke.chunk_case_ids(name)
    perm, packed_dst, _ = pack_edges_by_tile(dst, chip_smoke.CHUNK_NODES)
    return perm, packed_dst, chip_smoke.CHUNK_NODES, len(dst)


def case(name, datasets):  # noqa: F811
    return lipo_flat_case(datasets) if name == "lipo_flat_batch" else built_case(name)


def jax_sum(data, perm, packed_dst, V):
    return bits(jax_packed(jnp.asarray(data).astype(jnp.bfloat16), jnp.asarray(perm), jnp.asarray(packed_dst),
                           num_nodes=V, interpret=True))


@pytest.mark.parametrize("name", ["lipo_flat_batch", *chip_smoke.CHUNK_CASES])
def test_row_9b_plain_version_gives_the_jax_kernels_bits(datasets, name):  # noqa: F811
    perm, packed_dst, V, E = case(name, datasets)
    data = bf16_messages(E, 64, seed=len(name))
    ref = jax_sum(data, perm, packed_dst, V)
    got = bits(csr_segment_sum_packed_bf16_reference(torch.from_numpy(data).bfloat16(), torch.from_numpy(perm),
                                                     torch.from_numpy(packed_dst), V))
    differ = int((got != ref).sum())
    assert differ == 0, f"{differ} of {got.size} elements differ from the JAX kernel's"


def test_row_9b_plain_version_gives_the_jax_kernels_bits_at_an_8_byte_width():
    """Row 9b at d = 12, a width whose bf16 rows are not 16-byte aligned
    (d % 8 == 4), where the kernel reads 8-byte vectors of 4 values: the
    plain version against JAX's kernel in interpret mode on the straddling
    case, bit for bit."""
    perm, packed_dst, V, E = built_case(chip_smoke.CHUNK_CASES[0])
    data = bf16_messages(E, 12, seed=12)
    ref = jax_sum(data, perm, packed_dst, V)
    got = bits(csr_segment_sum_packed_bf16_reference(torch.from_numpy(data).bfloat16(), torch.from_numpy(perm),
                                                     torch.from_numpy(packed_dst), V))
    assert got.shape == (V, 12)
    differ = int((got != ref).sum())
    assert differ == 0, f"{differ} of {got.size} elements differ from the JAX kernel's"


def test_rounding_once_fails_the_comparison(datasets):  # noqa: F811
    """The control: the f32 sum of a node's rows rounded once to bf16
    differs from the JAX kernel where a run straddles a chunk boundary, so
    the comparison above sees where the rounding happens."""
    perm, packed_dst, V, E = built_case("straddle")
    data = bf16_messages(E, 64, seed=len("straddle"))
    ref = jax_sum(data, perm, packed_dst, V)
    dst = np.full(E, V, np.int64)
    dst[perm[perm >= 0]] = packed_dst[perm >= 0]
    once = torch.zeros(V + 1, 64).index_add_(0, torch.from_numpy(dst), torch.from_numpy(data))[:V]
    assert int((bits(once.bfloat16()) != ref).sum()) > 0


def test_wrapper_and_gradient_on_the_cpu(datasets):  # noqa: F811
    """On CPU tensors the wrapper takes the plain version (no launch),
    gives bf16, and its gradient is JAX's: the masked gather of the
    cotangent, bit for bit."""
    perm, packed_dst, V, E = lipo_flat_case(datasets)
    ds, _ = datasets
    G = next(iter(DataLoader(ds, batch_size=64, layout="flat", csr_pack=True)))["inputs.G"]
    data = bf16_messages(E, 32, seed=3)
    g = bf16_messages(V, 32, seed=4)
    before = (csr_segment_sum_packed.launches, csr_segment_sum_packed.launches_bf16)
    x = torch.from_numpy(data).bfloat16().requires_grad_()
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in (("perm", perm), ("packed_dst", packed_dst),
                                                         ("dst", G.dst), ("edge_mask", G.edge_mask))}
    out = csr_segment_sum_packed(x, t["perm"], t["packed_dst"], V, dst=t["dst"], edge_mask=t["edge_mask"])
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    assert (csr_segment_sum_packed.launches, csr_segment_sum_packed.launches_bf16) == before

    def f(x):
        return jax_packed(x, jnp.asarray(perm), jnp.asarray(packed_dst), num_nodes=V, dst=jnp.asarray(G.dst),
                          edge_mask=jnp.asarray(G.edge_mask), interpret=True)

    ref, vjp = jax.vjp(f, jnp.asarray(data).astype(jnp.bfloat16))
    np.testing.assert_array_equal(bits(out.detach()), bits(ref))
    np.testing.assert_array_equal(bits(x.grad), bits(vjp(jnp.asarray(g).astype(jnp.bfloat16))[0]))


def block_drift(seed: int = 0, d: int = 32):
    """The bf16 csr block on a packed flat batch of six molecules against
    JAX's, from the same weights and bf16 inputs: (output drifts relative to
    each output's largest magnitude, {gradient: drift relative to its
    largest magnitude, the bias's to the block's largest gradient})."""
    rng = np.random.default_rng(seed)
    bg = graph.with_csr_packing(graph.pad_graphs([PIPE(s) for s in SMIS], 128, 256, graph_cap=8, np_out=True))
    jG = jax.tree.map(jnp.asarray, jax_graph.with_csr_packing(
        jax_graph.pad_graphs([JAX_PIPE(s) for s in SMIS], 128, 256, graph_cap=8, np_out=True)))
    nf, ef = bf16_messages(128, d, seed), bf16_messages(256, d, seed + 1)
    gn, ge = rng.normal(size=(128, d)).astype(np.float32), rng.normal(size=(256, d)).astype(np.float32)
    kw = dict(hidden_dim=d, depth=3, impl="csr", dtype=BF16)
    jblock = jax_registry.build({"class": "ChempropBlock", "args": kw})
    jnf, jef = jnp.asarray(nf).astype(jnp.bfloat16), jnp.asarray(ef).astype(jnp.bfloat16)
    params = jblock.init(jax.random.PRNGKey(seed), jG.replace(node_feats=jnf, edge_feats=jef))["params"]

    def f(params, nf, ef):
        out = jblock.apply({"params": params}, jG.replace(node_feats=nf, edge_feats=ef))
        loss = (out.node_feats.astype(jnp.float32) * gn).sum() + (out.edge_feats.astype(jnp.float32) * ge).sum()
        return loss, out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, jnf, jef)
    block = ChempropBlock(**kw)
    _port_params(params, block)
    x_n = torch.from_numpy(nf).bfloat16().requires_grad_()
    x_e = torch.from_numpy(ef).bfloat16().requires_grad_()
    got = block(bg.to("cpu").update(node_feats=x_n, edge_feats=x_e))
    assert got.node_feats.dtype == torch.bfloat16
    ((got.node_feats.float() * torch.from_numpy(gn)).sum() + (got.edge_feats.float() * torch.from_numpy(ge)).sum()
     ).backward()
    outs = {"node_feats": (got.node_feats, out.node_feats), "edge_feats": (got.edge_feats, out.edge_feats)}
    out_drift = {k: float(np.abs(bits(a.detach()) - bits(b)).max() / np.abs(bits(b)).max())
                 for k, (a, b) in outs.items()}
    ref = {k.removeprefix("m."): v.numpy()
           for k, v in params_from_jax({"modules__m": jax.device_get(grads[0])}).items()}
    ref |= {"node_feats": bits(grads[1]), "edge_feats": bits(grads[2])}
    got_grads = {**{n: p.grad.numpy() for n, p in block.named_parameters()}, "node_feats": bits(x_n.grad),
                 "edge_feats": bits(x_e.grad)}
    scale = max(float(np.abs(r).max()) for r in ref.values())
    grad_drift = {n: float(np.abs(got_grads[n] - r).max()) / (scale if n == "bias" else float(np.abs(r).max()))
                  for n, r in ref.items()}
    return out_drift, grad_drift


def test_csr_block_at_bf16_matches_jax():
    """ChempropBlock(impl="csr", dtype="bfloat16") against JAX's: every
    E->V sum through row 9b (plain) and the JAX kernel (interpret mode);
    outputs at PRED_RTOL of their largest magnitude, weight and input
    gradients at GRAD_RTOL, the stacked bias at BIAS_GRAD_RTOL of the
    block's largest gradient."""
    outs, grads = block_drift()
    assert all(v <= PRED_RTOL for v in outs.values()), outs
    for name, err in grads.items():
        assert err <= (BIAS_GRAD_RTOL if name == "bias" else GRAD_RTOL), (name, err)


def ulps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|got - ref| in bf16 ulps of ``ref`` (the spacing of bf16 values at
    each element's magnitude: 2^-7 of its power of two)."""
    spacing = np.ldexp(1.0, np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))).astype(int) - 7)
    return np.abs(got - ref) / spacing


def served_against_jax(ckpt, csv_path, datasets):  # noqa: F811
    """An ``impl: csr`` bf16 checkpoint's predictions of the first N lipo
    molecules in batches of 64: ``served`` (the port's ``run_predict``),
    ``raw`` (the port's model output before the task transform, on the
    packed batches ``run_predict`` serves), JAX's model output on the same
    packed batches (``jax_packed``) and on the unpacked flat batches its
    ``run_predict`` serves (``jax_unpacked``), and JAX's ``predict`` with
    the task transform on the packed batches (``jax_served``)."""
    ds, jds = datasets
    meta = json.loads((ckpt / "predict_meta.json").read_text())
    kw = dict(hidden_dim=D, depth=2, impl="csr", layout="flat", dtype=BF16)
    transforms = {name: {"preds": {"module": jax_task_transforms.deserialize(tr["preds"]), "key": "ffn.preds"},
                         "targets": {"module": jax_task_transforms.deserialize(tr["targets"]),
                                     "key": f"targets.{name}"}}
                  for name, tr in meta["transforms"].items()}
    params = params_to_jax(Checkpointer(ckpt).restore())
    model = build_dmpnn(**kw)
    model.network.load_state_dict(Checkpointer(ckpt).restore())
    packed = {"batch_size": 64, "layout": "flat", "csr_pack": True, "node_quantum": 256}
    out = {"served": run_predict(ckpt, csv_path, batch_size=64, device="cpu")["lipo"],
           "raw": predict(model, DataLoader(ds, **packed), keys=["ffn.preds"])["ffn.preds"]}
    for name, jmodel, loader in (
            ("jax_packed", jax_build_dmpnn(**kw), JaxDataLoader(jds, **packed)),
            ("jax_unpacked", jax_build_dmpnn(**kw), JaxDataLoader(jds, batch_size=64, layout="flat")),
            ("jax_served", jax_build_dmpnn(transforms=transforms, **kw), JaxDataLoader(jds, **packed))):
        out[name] = jax_predict(jmodel, params, loader, keys=["ffn.preds"])["ffn.preds"]
    return {k: np.asarray(v, np.float32)[:N].reshape(N) for k, v in out.items()}


# the port's raw predictions against JAX's on the unpacked batches of its
# run_predict (XLA's bf16 scatter-add, each add rounded, where row 9b rounds
# each chunk's f32 partial): a node that straddles a chunk rounds otherwise,
# and the flip grows through the layers to the output's last bits. Measured
# (hidden 16, depth 2, 2 epochs): 41 of 96 predictions differ, by 1 or 2 bf16
# ulps of the prediction (5.2e-3 of the largest |prediction|: more than
# PRED_RTOL, which is one ulp only at the top of a power of two)
UNPACKED_ULPS = 2


def test_train_and_serve_csr_bf16_through_the_clis(datasets, lipo_csv, tmp_path):  # noqa: F811
    """configs/dmpnn_regression.yaml with model.impl=csr model.dtype=bfloat16
    trains and serves through the CLIs with --cpu. The port's raw predictions
    have the bits of JAX's predict on the same packed batches (the Pallas
    kernel in interpret mode: every reduce rounds as row 9b does), and lie
    within UNPACKED_ULPS of JAX's on the unpacked batches its run_predict
    serves. The served (denormalized) predictions agree with JAX's predict
    with the task transform at PRED_RTOL: under jit XLA keeps the head's
    f32 value through its bf16 rounding into the transform (measured
    9.05e-4 of the largest), where the port and JAX's eager transform
    denormalize the rounded output."""
    ckpt = tmp_path / "ckpt"
    lines = _cli("train", "configs/dmpnn_regression.yaml", f"data.csv={lipo_csv}", "model.impl=csr",
                 f"model.dtype={BF16}", f"model.hidden_dim={D}", "model.depth=2", "trainer.epochs=2",
                 "trainer.batch_size=32", f"trainer.checkpoint_dir={ckpt}")
    assert [r["epoch"] for r in lines[:2]] == [0, 1] and np.isfinite(lines[2]["test"]["val/rmse"])
    meta = json.loads((ckpt / "predict_meta.json").read_text())
    assert (meta["model"]["layout"], meta["model"]["impl"], meta["model"]["dtype"]) == ("flat", "csr", BF16)
    out = tmp_path / "preds.csv"
    assert _cli("predict", ckpt, lipo_csv, "-o", out) == [{"predictions_csv": str(out)}]
    p = served_against_jax(ckpt, lipo_csv, datasets)
    np.testing.assert_allclose(p["served"], [float(x) for x in out.read_text().split()[1:]], rtol=1e-5, atol=1e-5)
    assert np.isfinite(p["served"]).all()
    np.testing.assert_array_equal(p["raw"], p["jax_packed"])
    assert float(ulps(p["raw"], p["jax_unpacked"]).max()) <= UNPACKED_ULPS
    assert float(np.abs(p["served"] - p["jax_served"]).max()) <= PRED_RTOL * float(np.abs(p["jax_served"]).max())


FUSED_BF16 = {"dense_packed": "dense_packed", "dense_fused": "dense"}  # layout -> its loader's


@pytest.mark.parametrize("layout", sorted(FUSED_BF16))
def test_both_packages_refuse_the_fused_layouts_at_bf16(datasets, layout):  # noqa: F811
    """The JAX package's fused kernels raise ValueError on a bf16 D-MPNN
    (its first forward: the bf16 store refuses the state layer 0's f32 bias
    promoted); the port refuses the model when it is built."""
    ds, jds = datasets
    jmodel = jax_build_dmpnn(hidden_dim=8, depth=2, dtype=BF16, layout=layout,
                             transforms=jds.build_task_transform_configs())
    batch = next(iter(JaxDataLoader(jds, batch_size=BATCH, layout=FUSED_BF16[layout])))
    with pytest.raises(ValueError, match="Invalid dtype for `swap`"):
        jmodel.init(jax.random.PRNGKey(0), batch)
    with pytest.raises(NotImplementedError, match="dense_mpnn.py:179-185"):
        build_dmpnn(hidden_dim=8, depth=2, dtype=BF16, layout=layout)


def test_both_packages_refuse_a_fused_block_after_a_bf16_embedding(datasets):  # noqa: F811
    """A declarative FusedDenseChempropBlock fed by a bf16
    DenseGraphEmbedding: ValueError in JAX's kernel, NotImplementedError in
    the port's forward."""
    ds, jds = datasets
    cfg = {"layout": "dense", "pred_key": "ffn.preds", "modules": {
        "embed": {"class": "DenseGraphEmbedding",
                  "args": {"num_node_types": DEFAULT_NUM_ATOM_TYPES, "num_edge_types": DEFAULT_NUM_BOND_TYPES,
                           "hidden_dim": 8, "dtype": BF16},
                  "in_keys": ["inputs.G"], "out_keys": ["G"]},
        "mp": {"class": "FusedDenseChempropBlock", "args": {"hidden_dim": 8, "depth": 2}, "in_keys": ["embed.G"],
               "out_keys": ["G"]},
        "readout": {"class": "DenseMean", "in_keys": ["mp.G"], "out_keys": ["H"]},
        "ffn": {"class": "MLP", "args": {"input_dim": 8, "output_size": 1, "hidden_dim": 8, "num_layers": 1},
                "in_keys": ["readout.H"], "out_keys": ["preds"]}},
        "losses": {"mse": {"class": "MSE", "in_keys": {"preds": "ffn.preds", "targets": "targets.y",
                                                        "mask": "targets.y_mask"}}}}
    jmodel = jax_build_model(cfg, jds.build_task_transform_configs(), None)
    with pytest.raises(ValueError, match="Invalid dtype for `swap`"):
        jmodel.init(jax.random.PRNGKey(0), next(iter(JaxDataLoader(jds, batch_size=BATCH, layout="dense"))))
    model = build_model(cfg, ds.build_task_transform_configs())
    batch = next(iter(DataLoader(ds, batch_size=BATCH, layout="dense")))
    with pytest.raises(NotImplementedError, match="dense_mpnn.py:179-185"):
        model.network(to_device(batch, "cpu"))


if __name__ == "__main__":  # the served drifts the CLI test holds, and the block's
    import sys
    import tempfile
    from pathlib import Path

    from .test_torch_gat import datasets_of, lipo_head

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        csv_path = lipo_head(tmp / "lipo.csv", N)
        _cli("train", "configs/dmpnn_regression.yaml", f"data.csv={csv_path}", "model.impl=csr", f"model.dtype={BF16}",
             f"model.hidden_dim={D}", "model.depth=2", "trainer.epochs=2", "trainer.batch_size=32",
             f"trainer.checkpoint_dir={tmp / 'ckpt'}")
        p = served_against_jax(tmp / "ckpt", csv_path, datasets_of(csv_path))
        print(json.dumps({"raw_vs_jax_packed_elements": int((p["raw"] != p["jax_packed"]).sum()),
                          "raw_vs_jax_unpacked_elements": int((p["raw"] != p["jax_unpacked"]).sum()),
                          "raw_vs_jax_unpacked_ulps": float(ulps(p["raw"], p["jax_unpacked"]).max()),
                          "served_vs_jax_served": float(np.abs(p["served"] - p["jax_served"]).max()
                                                        / np.abs(p["jax_served"]).max()),
                          "block": block_drift()}), file=sys.stdout)
