"""
Card-only tests of fleet serving: a group of Transformer machines scored
by ``FleetScorer`` on the card launches the flash forward once a layer
for the whole group, and agrees with the same scorer on the CPU (1e-4
in float32; 2e-2 for a bf16 group computing in bfloat16, whose forward
runs the quad kernel on bfloat16 inputs). They skip without a card.

Like tests/test_torch_cuda.py this file imports neither JAX nor the JAX
package: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_fleet_serving.py`` on a machine with PyTorch only.
"""

import numpy as np
import pytest
import torch

from gordo_tpu_torch.models import TransformerAutoEncoder
from gordo_tpu_torch.ops import flash_attention as fa
from gordo_tpu_torch.server.fleet_serving import FleetScorer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KWARGS = dict(kind="transformer_model", lookback_window=16, d_model=64, n_heads=4, n_layers=2,
              epochs=1, attention_impl="flash")


def _estimators(device, dtype, precision, n=4):
    """``n`` machines fitted on the CPU from seeds, loaded onto ``device``."""
    out = {}
    rng = np.random.default_rng(0)
    for i in range(n):
        X = rng.normal(size=(80, 3)).astype("float32")
        fitted = TransformerAutoEncoder(**KWARGS, dtype=dtype, seed=i).fit(X, X, device="cpu")
        est = TransformerAutoEncoder(fitted.kind, **fitted.kwargs)
        est.load_state_arrays(fitted.state_arrays(), device)
        est.precision_ = precision
        out[f"m{i}"] = est
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precision,tol", [("float32", "float32", 1e-4),
                                                 ("bfloat16", "bf16", 2e-2)])
def test_a_group_launches_one_flash_forward_a_layer(dtype, precision, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    card = FleetScorer(_estimators("cuda", dtype, precision))
    cpu = FleetScorer(_estimators("cpu", dtype, precision))
    rng = np.random.default_rng(1)
    inputs = {f"m{i}": rng.normal(size=(144, 3)).astype("float32") for i in range(4)}
    fa.reset_launch_counts()
    got = card.predict(inputs)
    torch.cuda.synchronize()
    assert fa.launch_counts == {fa.KERNEL: 2, fa.KERNEL_DQ: 0, fa.KERNEL_DKV: 0}
    assert fa.typed_launches == {f"{fa.KERNEL}_quad_{dtype}": 2}
    want = cpu.predict(inputs)
    for name in inputs:
        assert got[name].dtype == np.float32
        assert np.abs(got[name] - want[name]).max() <= tol * max(1.0, np.abs(want[name]).max())
