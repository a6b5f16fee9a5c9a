"""The full-width GVP run, port-CPU against JAX-CPU, taken apart.

With the sum readout and Adam at 1e-3, the two packages' two-epoch runs
drift apart by 1.18e-1 (``tests/test_torch_spatial.py::
test_gvp_full_width_run_drifts_apart_in_both_packages`` now holds a calmer
recipe, the mean readout at 3e-5, within 1e-3). These tests say where that
drift comes from:

- in lockstep, every step of the first epoch starts both packages from
  JAX's parameters (JAX's own optimizer carries its state from step to
  step; the state enters neither a step's loss nor its gradients), so a
  step that computes something else would show here as a difference in
  loss or in a gradient, where the whole run cannot tell it from chaos;
- the calmer run is the same two epochs with the targets normalised over
  the training clouds (the loss still starts near 800: the untrained
  model's sum readout, not the targets, sets its scale, and the run drifts
  as far);
- and the port's CPU side gives the same bits twice in one process and in
  two fresh processes, so a run's drift is a number and not a draw (the
  neighbour gathers used to add their gradients by float atomics across
  threads).

The model is the declarative GVP model (scalar 256, vector 32, depth 3,
the sum readout, Adam at 1e-3, ``GvpGNNBlock(impl: fused)``, which takes
the plain versions of TPU kernel rows 14-15 on the CPU); the JAX side runs
its jnp conv.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.training.loop import fit as jax_fit
from notorch_tpu_torch.cli.train import build_model
from notorch_tpu_torch.data.point_cloud import cloud_batches, coordination_targets, make_clouds
from notorch_tpu_torch.kernels.gvp_conv import gvp_conv_bwd_reference, weight_shapes
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.nn.spatial.gvp import nbr_take
from notorch_tpu_torch.nn.spatial.neighbors import radius_neighbors
from notorch_tpu_torch.training.loop import fit, to_device
from notorch_tpu_torch.training.optim import OptimizerSpec
from tests.test_torch_spatial import declarative_gvp_cfg, few_torch_threads, jax_batch  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's GVP lockstep: each step's loss (relative) and each
# gradient (relative L2; a few ReLU pre-activations of a full-width batch lie
# within rounding of their kink, and a slot that takes the other side moves
# its gradient by a whole term)
LOCKSTEP_RTOL = 1e-4
GRAD_REL_L2 = 1e-2
# the calmer run's limit: twice the largest drift measured over 5 fresh
# processes at the tier-1 thread count (8 threads: 1.392e-1 in each) and 5
# at one thread (1.36e-3 in each), rounded up (CHANGES.md)
CALM_RUN_RTOL = 2.8e-1


def full_width():
    """(JAX model, its initial state, a port model with the same weights)."""
    jmodel = jax_build_model(declarative_gvp_cfg(256, 32, 3, "jnp"), None, optax.adam(1e-3))
    return jmodel, build_model(declarative_gvp_cfg(256, 32, 3), None, optimizer=OptimizerSpec("adam", 1e-3))


def jax_step_with_grads(jmodel):
    """JAX's train step (the loss, Adam from the carried optimizer state),
    returning the loss and the gradients too."""

    def loss_fn(params, batch):
        out = jmodel.network.apply({"params": params}, dict(batch), training=True)
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    def step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        updates, opt_state = jmodel.optimizer.update(grads, state.opt_state, state.params)
        state = state.replace(params=optax.apply_updates(state.params, updates), opt_state=opt_state,
                              step=state.step + 1)
        return state, loss, grads

    return jax.jit(step)


def lockstep(batches):
    """Each batch's step in both packages from JAX's parameters: the largest
    relative loss difference, the largest relative L2 distance of a
    gradient, and that gradient's name."""
    jmodel, model = full_width()
    state = jmodel.init(jax.random.PRNGKey(0), jax_batch(batches[0]))
    step = jax_step_with_grads(jmodel)
    loss_diff, grad_diff, worst = 0.0, 0.0, None
    for batch in batches:
        model.network.load_state_dict(params_from_jax(jax.device_get(state.params)))
        ours = float(model.train_step(to_device(batch, "cpu"))["train/loss"])
        state, loss, grads = step(state, jax_batch(batch))
        loss_diff = max(loss_diff, abs(ours - float(loss)) / abs(float(loss)))
        ref = params_from_jax(jax.device_get(grads))
        for name, p in model.network.named_parameters():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            err = float((got - ref[name]).norm() / ref[name].norm().clamp_min(1e-30))
            if err > grad_diff:
                grad_diff, worst = err, name
    return loss_diff, grad_diff, worst


def normalised_batches():
    """The run's 512 training and 64 validation clouds in batches of 64,
    the targets normalised to mean 0 and std 1 over the training clouds."""
    train_clouds, val_clouds = make_clouds(512, seed=0), make_clouds(64, seed=1)
    y_train, y_val = coordination_targets(train_clouds), coordination_targets(val_clouds)
    mean, std = y_train.mean(), y_train.std()
    return (cloud_batches(train_clouds, ((y_train - mean) / std).astype(np.float32)),
            cloud_batches(val_clouds, ((y_val - mean) / std).astype(np.float32)))


def calm_run_drift(train, val):
    """The two-epoch run in both packages from JAX's initial weights: the
    largest relative difference of a per-epoch training or validation
    loss."""
    jmodel, model = full_width()
    state = jmodel.init(jax.random.PRNGKey(0), jax_batch(train[0]))
    model.network.load_state_dict(params_from_jax(jax.device_get(state.params)))
    ours = fit(model, train, val, epochs=2).history
    theirs = jax_fit(jmodel, state, [jax_batch(b) for b in train], [jax_batch(b) for b in val], epochs=2).history
    return max(abs(a[k] - float(b[k])) / abs(float(b[k])) for a, b in zip(ours, theirs)
               for k in ("train/loss", "val/loss"))


def test_every_step_of_the_first_epoch_agrees_in_lockstep():
    """The first epoch's 8 steps of the run that drifts 1.17e-1: each step's
    loss and every gradient agree, so the drift is the run's own growth of
    rounding differences, not a step that computes something else."""
    train = cloud_batches(make_clouds(512, seed=0), coordination_targets(make_clouds(512, seed=0)))
    loss_diff, grad_diff, worst = lockstep(train)
    assert loss_diff <= LOCKSTEP_RTOL, loss_diff
    assert grad_diff <= GRAD_REL_L2, (grad_diff, worst)


def test_the_calmer_run_stays_close_in_both_packages():
    """The same two epochs on normalised targets, the same numpy arrays in
    both packages: the per-epoch losses stay within CALM_RUN_RTOL."""
    drift = calm_run_drift(*normalised_batches())
    assert drift <= CALM_RUN_RTOL, drift


@pytest.mark.parametrize("gather", ["plain_conv", "nbr_take"])
def test_the_neighbour_gathers_backward_gives_the_same_bits_twice(gather):
    """The CPU backward through the GVP neighbour gathers, twice on the
    first batch of 64 clouds (1,216 nodes, 16 slots): the same bits. The
    gathers were ``x[idx]``, whose backward adds by float atomics across
    threads and gave other bits on every call; they are ``index_select``."""
    batch = cloud_batches(make_clouds(64, seed=0))[0]["inputs.P"]
    nbrs, mask, dists = radius_neighbors(torch.from_numpy(batch.coords), torch.from_numpy(batch.batch_index), 5.0,
                                         16, window=24)
    N, K = nbrs.shape
    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    if gather == "plain_conv":
        ds, dv, nb = 32, 8, 16
        ws = [f32(*shape, scale=1 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1)
              for shape in weight_shapes(ds, dv, nb)]
        args = [f32(N, ds), f32(N, dv), f32(N, dv), f32(N, dv), nbrs, mask, f32(N * K, nb), f32(N * K, 1),
                f32(N * K, 1), f32(N * K, 1), ws]
        cot = [f32(N, ds), f32(N, dv), f32(N, dv), f32(N, dv)]
        runs = [gvp_conv_bwd_reference(*args, *cot, 24) for _ in range(2)]
        runs = [list(r[:8]) + list(r[8]) for r in runs]
    else:
        x, g = f32(N, 3, 8).requires_grad_(), f32(N, K, 3, 8)
        runs = [torch.autograd.grad(nbr_take(x, nbrs), x, g) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# the probes' thread count: small, so that two probes beside tier-1's busy
# workers do not oversubscribe the cores (at the default count each probe
# took up to ~200 s under such load, near the old 300 s limit, against ~7 s
# alone), and above 1, so that a sum whose order follows the threads (the
# float atomics of the old neighbour gathers) still shows as other bits.
# The bits depend on the count: MKL's sgemm splits the weight gradients'
# sums over the N * K neighbour rows between its threads (1, 2, 3 and 4
# threads give four digests; the forward of the first step is the same).
# MKL and OpenMP may run fewer threads than they are set to when their
# dynamic modes are on (MKL_DYNAMIC is on by default), a choice of theirs
# that no call of the port sees, so the probes turn both modes off and set
# every thread count (PROBE_ENV)
PROBE_THREADS = 2
PROBE_ENV = {"OMP_NUM_THREADS": str(PROBE_THREADS), "MKL_NUM_THREADS": str(PROBE_THREADS), "MKL_DYNAMIC": "FALSE",
             "OMP_DYNAMIC": "FALSE"}
PROBE_TIMEOUT_S = 300
PROBE = f"""
import hashlib, json, sys, torch
torch.set_num_threads({PROBE_THREADS})
from notorch_tpu_torch.cli.train import build_model
from notorch_tpu_torch.data.point_cloud import cloud_batches, coordination_targets, make_clouds
from notorch_tpu_torch.training.loop import to_device
from notorch_tpu_torch.training.optim import OptimizerSpec
clouds = make_clouds(96, seed=0)
model = build_model(json.loads(sys.argv[1]), None, generator=torch.Generator().manual_seed(0),
                    optimizer=OptimizerSpec("adam", 1e-3))
digest = hashlib.sha256()
for batch in cloud_batches(clouds, coordination_targets(clouds), batch_size=32):
    digest.update(model.train_step(to_device(batch, "cpu"))["train/loss"].numpy().tobytes())
    for p in model.network.parameters():
        if p.grad is not None:
            digest.update(p.grad.numpy().tobytes())
print(json.dumps(digest.hexdigest()))
"""


def test_two_fresh_processes_train_to_the_same_bits():
    """Three train steps of the declarative GVP model (scalar 64, vector 16)
    at PROBE_THREADS threads in two fresh processes: every loss and
    gradient the same bits. A probe that outlasts PROBE_TIMEOUT_S fails as
    a time-out, not as a difference of bits."""
    env = {**os.environ, "PYTHONPATH": ROOT, **PROBE_ENV}
    cfg = json.dumps(declarative_gvp_cfg(64, 16, 3))
    runs = []
    for i in range(2):
        try:
            runs.append(subprocess.run([sys.executable, "-c", PROBE, cfg], env=env, cwd=ROOT, capture_output=True,
                                       text=True, timeout=PROBE_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            pytest.fail(f"probe {i + 1} of 2 did not finish in {PROBE_TIMEOUT_S} s (a time-out, no bits compared)")
    for run in runs:
        assert run.returncode == 0, run.stderr[-2000:]
    first, second = (json.loads(run.stdout.strip().splitlines()[-1]) for run in runs)
    assert first == second
