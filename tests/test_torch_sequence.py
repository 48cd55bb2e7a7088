"""
The port's sequence-parallel attention (``parallel/sequence.py``) against
the JAX package's ``sequence_sharded_attention``: ring and Ulysses,
causal and full, on 2 and 4 gloo ranks (the JAX side on as many virtual
CPU devices), forward and the gradients of q, k and v, atol 1e-5. The
same seeded numpy inputs go to both; every rank returns the whole output
and the whole gradients, which must agree between ranks too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gordo_tpu.parallel.mesh import get_device_mesh as jax_mesh
from gordo_tpu.parallel.sequence import SEQ_AXIS
from gordo_tpu.parallel.sequence import sequence_sharded_attention as jax_attention
from tests.torch_distributed_helpers import run_cluster

ATOL = 1e-5
WORLDS = (2, 4)


def _inputs(world: int) -> dict:
    rng = np.random.default_rng(world)
    shape = (2, 8 * world, 4, 8)  # 4 heads: Ulysses splits them over 4 ranks
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name in ("q", "k", "v", "cot")}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    return {world: run_cluster("sequence", world, tmp_path_factory.mktemp(f"seq{world}"), {},
                               _inputs(world))
            for world in WORLDS}


def _jax_reference(world, impl, causal):
    arrays = _inputs(world)
    mesh = jax_mesh(shape=(world,), axis_names=(SEQ_AXIS,))

    def objective(q, k, v):
        out = jax_attention(q, k, v, mesh, impl=impl, causal=causal)
        return jnp.sum(out * arrays["cot"]), out

    step = jax.jit(jax.value_and_grad(objective, argnums=(0, 1, 2), has_aux=True))
    (_, out), grads = step(*(jnp.asarray(arrays[name]) for name in ("q", "k", "v")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ("ring", "ulysses"))
@pytest.mark.parametrize("causal", (False, True))
def test_sequence_sharded_attention_matches_jax(clusters, world, impl, causal):
    out, grads = _jax_reference(world, impl, causal)
    tag = f"{impl}-{int(causal)}"
    for rank, got in enumerate(clusters[world]):
        np.testing.assert_allclose(got[f"{tag}-out"], out, rtol=0, atol=ATOL,
                                   err_msg=f"rank {rank}")
        for name, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[f"{tag}-{name}"], want, rtol=0, atol=ATOL,
                                       err_msg=f"rank {rank} {name}")


def test_one_rank_ring_is_the_identity_rotation(tmp_path):
    """At one rank the ring sends nothing (gloo and nccl refuse a rank
    sending to itself) and the result is plain attention."""
    outs = run_cluster("sequence", 1, tmp_path, {}, _inputs(1))
    out, grads = _jax_reference(1, "ring", True)
    np.testing.assert_allclose(outs[0]["ring-1-out"], out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(outs[0]["ring-1-dk"], grads[1], rtol=0, atol=ATOL)


def test_errors_match_jax():
    import torch

    from gordo_tpu_torch.parallel import sequence

    class _Mesh:
        mesh_dim_names = (SEQ_AXIS,)
        shape = (3,)

    q = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="Unknown sequence-parallel impl 'bogus'"):
        sequence.sequence_sharded_attention(q, q, q, _Mesh(), impl="bogus")
    with pytest.raises(ValueError, match="Sequence length 8 not divisible by mesh axis 'seq'"):
        sequence.sequence_sharded_attention(q, q, q, _Mesh())
    with pytest.raises(ValueError, match="is not bound"):
        sequence.ring_attention(q, q, q)
