"""Every task type's head, loss and transforms on a bf16 D-MPNN
(``build_dmpnn(dtype="bfloat16", task=...)``, the plain dense layout),
port against JAX on the CPU from JAX's initial weights: the first train
step's loss and the predictions in data units or probabilities.

The losses take the bf16 head's outputs with JAX's promotions (f32 targets
and masks make them f32), so the first step's losses agree within 1.6e-4
(the evidential loss; the rest exactly), held at LOSS_RTOL = 5e-4. The
prediction transforms run in bf16 where the head's output is bf16 (a
sigmoid, a softmax, a softplus), and the two frameworks' bf16
transcendental functions differ by a rounding: predictions agree within
1.14e-2 of the largest (the Dirichlet head's normalised alphas), 4.4e-3 for
the classification heads and 9.4e-8 for regression, held at PRED_RTOL =
3e-2 (the regression and MVE heads' data-unit outputs go through f32
transforms and agree to f32).
"""

import jax
import numpy as np
import pytest

from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.training.loop import predict, to_device

from .test_torch_task_models import BATCH, CLASSES, T, TASKS, datasets, jax_loss_and_grads

LOSS_RTOL, PRED_RTOL = 5e-4, 3e-2


@pytest.mark.parametrize("task", TASKS)
def test_bf16_dmpnn_takes_every_task_type(task):
    ds, jds = datasets(task)
    kw = dict(num_tasks=T, task=task, num_classes=CLASSES, hidden_dim=16, depth=2, dtype="bfloat16")
    jmodel = jax_build_dmpnn(transforms=jds.build_task_transform_configs(), **kw)
    model = build_dmpnn(transforms=ds.build_task_transform_configs(), **kw)
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, layout="dense"))
    batches = list(DataLoader(ds, batch_size=BATCH, layout="dense"))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params)
    model.network.load_state_dict(params_from_jax(params))
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    ref = np.asarray(jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"], np.float32)
    assert preds.shape == ref.shape and np.isfinite(preds).all()
    assert np.abs(preds - ref).max() <= PRED_RTOL * np.abs(ref).max()
    loss, _ = jax_loss_and_grads(jmodel, params, jbatches[0])
    got = float(model.train_step(to_device(batches[0], "cpu"))["train/loss"])
    assert abs(got - loss) <= LOSS_RTOL * abs(loss), (got, loss)
