"""The port's training at the Diabetes130 recipe's field count against the
JAX package, on the CPU at narrow widths: db_armnet1h
(armnet_tpu/utils/presets.py) has 43 fields and alpha 1.7, past the CUDA
kernels' 40-field register bucket (the fused kernels then hold each gate
column in shared memory). The port runs the kernels' plain versions here;
tests/test_torch_cuda.py holds the kernels to them on the card. Inputs from
seeded numpy and weights bridged from the JAX init, as in
tests/test_torch_train.py.
"""

import numpy as np
import pytest
import torch

from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)
from test_torch_train import (LR, _run_jax, init_pair, make_batches,
                              small_kw, to_torch)


@pytest.mark.parametrize("backend", ["auto", "pallas-fused"])
def test_trajectory_at_43_fields(backend):
    """The 25-step trajectory above at the Diabetes130 recipe's 43 fields
    and alpha 1.7 (db_armnet1h, narrow widths): past the CUDA kernels'
    40-field bucket, whose plain versions the port runs here; the JAX side
    through its Pallas entmax kernels (auto; its default path on the CPU)
    or its fused ARM-1h kernels in interpret mode. Same tolerances."""
    kw = small_kw(nfield=43, alpha=1.7)
    jm, params, stats, model = init_pair(kw, seed=5, kernels=backend)
    batches = make_batches(25, seed=6, pad_last=24, nfield=43)
    lj, yj = _run_jax(jm, params, stats, batches, backend)

    state = create_train_state(model, LR)
    step = make_train_step()
    meters, lt = init_meters("cpu"), []
    for b in batches:
        meters = step(state, meters, to_torch(b))
        lt.append(float(meters["loss_last"]))
    with torch.no_grad():
        yt = model.eval()(to_torch(batches[0])).numpy()
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(np.asarray(lt), lj, atol=5e-4)
    np.testing.assert_allclose(yt, yj, atol=1e-2)
