"""`eval_dtype: bfloat16` is another function in the port than the JAX
package's `generate()` at bfloat16, and this test pins by how much.

The port's bfloat16 chain follows `build_pallas_eval`
(mocodad_tpu/models/mocodad.py:528-565), the function that the JAX kernel
B1 at bfloat16 computes: the condition encoder in float32, x in bfloat16
between steps, each DDPM update computed in float32 from the float32 eps
and rounded back.  `eval_MoCoDAD.py` at bfloat16 runs `generate()`
instead (:401-407, :480-487): it casts every variable, the encoder's
included, to bfloat16, runs the XLA fast path and keeps the update in
bfloat16.  No kernel of either package computes that second function, so
the port keeps the first (held within 1.5e-3 by
tests/test_torch_generate_bf16.py) and this test holds the gap to the
second.

Setup: `CFG_KW`, B = 8, S = 5, `seeded_variables` seeds 13-15, the same
NumPy (x0, zs) given to both `generate`s as `noise_override`, the data
and the noise drawn from `default_rng(seed)`.  Per-window loss max |Δ| /
max |loss|, measured on the CPU with these draws: 3.0e-3, 6.3e-3 and
4.4e-3 for seeds 13, 14 and 15 (with other draws of the data and noise:
1.7e-3, 4.4e-3 and 5.6e-3).  The bound is 1e-2, and every seed lies above
the 1.5e-3 that the kernel-path test holds the port to; the float32
chains of the two packages agree within 3.1e-7 on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CFG_KW, seeded_variables, torch_net
from mocodad_tpu.config import Config as JaxConfig
from mocodad_tpu.models import MoCoDADModel as JaxModel
from mocodad_tpu_torch.config import Config as TorchConfig
from mocodad_tpu_torch.models.mocodad import MoCoDADModel as TorchModel

B, S = 8, 5
XLA_LOSS_REL = 1e-2            # the gap between the two bf16 functions
KERNEL_PATH_LOSS_REL = 1.5e-3  # tests/test_torch_generate_bf16.py:38


def _cfg(cls):
    cfg = cls(**{**CFG_KW, 'n_generated_samples': S})
    cfg.extras['eval_dtype'] = 'bfloat16'
    return cfg


@pytest.mark.parametrize('seed', [13, 14, 15])
def test_bf16_generate_against_jax_xla_generate(seed):
    jm, tm = JaxModel(_cfg(JaxConfig)), TorchModel(_cfg(TorchConfig))
    variables = seeded_variables(jm, seed=seed)
    net = torch_net(tm, variables)
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((B, 2, 6, 17)).astype(np.float32)
    x0 = rng.standard_normal((B * S, 2, 3, 17)).astype(np.float32)
    zs = rng.standard_normal((9, B * S, 2, 3, 17)).astype(np.float32)

    _, loss_j = jax.jit(lambda v, d, a, z: jm.generate(
        v, d, jax.random.key(0), noise_override=(a, z)))(
            variables, jnp.asarray(data), jnp.asarray(x0), jnp.asarray(zs))
    _, loss_t = tm.generate(net, torch.from_numpy(data),
                            noise_override=(torch.from_numpy(x0),
                                            torch.from_numpy(zs)))
    loss_j = np.asarray(loss_j, np.float64)
    assert np.isfinite(loss_j).all() and np.isfinite(loss_t.numpy()).all()
    rel = np.abs(loss_t.numpy() - loss_j).max() / np.abs(loss_j).max()
    assert rel <= XLA_LOSS_REL, rel
    # a difference of function, not of rounding noise: the kernel path's
    # bound does not hold against this function
    assert rel > KERNEL_PATH_LOSS_REL, rel
