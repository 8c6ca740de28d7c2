"""Port kernels vs the JAX kernels: the CPU branch of each wrapper in
``repro_torch.kernels.ops`` against the Pallas kernel in interpret mode, on
the same numpy inputs. Tolerances are ``tests/test_kernels.py``'s ATOL
(f32 2e-5, bf16 3e-2): both sides compute in f32 and round once."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import attn_template as T  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dt, scale=1.0):
    """The same values as a jax array and a torch CPU tensor of dtype dt."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(a).astype(JAX_DT[dt]),
            torch.from_numpy(a).to(TORCH_DT[dt]))


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL[dt])


@pytest.mark.parametrize("shape", [(4, 128), (2, 33, 257), (1, 7, 3, 64),
                                   (3, 4096)])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches_pallas(shape, dt, zero_centered):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, shape, dt)
    wj, wt = _pair(rng, (shape[-1],), dt)
    want = jops.rms_norm(xj, wj, zero_centered=zero_centered, interpret=True)
    got = ops.rms_norm(xt, wt, zero_centered=zero_centered)
    assert got.dtype == TORCH_DT[dt] and got.shape == xt.shape
    _close(got, want, dt)


@pytest.mark.parametrize("shape", [(4, 128), (2, 37, 257), (3, 1000)])
@pytest.mark.parametrize("dt", DTYPES)
def test_swiglu_matches_pallas(shape, dt):
    rng = np.random.default_rng(1)
    gj, gt = _pair(rng, shape, dt, scale=3.0)
    uj, ut = _pair(rng, shape, dt)
    want = jops.swiglu(gj, uj, interpret=True)
    got = ops.swiglu(gt, ut)
    assert got.dtype == TORCH_DT[dt]
    _close(got, want, dt)


# (B, Sq, Skv, Hq, Hkv, Dk, Dv, q_offset)
ATTN_CASES = [
    (2, 37, 37, 4, 4, 32, 32, 0),      # seq 37: ragged q and kv tiles
    (1, 37, 37, 8, 2, 32, 32, 0),      # GQA 8/2
    (2, 35, 35, 4, 4, 48, 16, 0),      # Dv != Dk
    (1, 13, 40, 4, 2, 32, 32, 27),     # q_offset: a chunk at the cache's end
    (1, 70, 70, 2, 2, 128, 128, 0),    # llama head width, two KV tiles
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_core_matches_pallas(case, dt):
    b, sq, skv, hq, hkv, dk, dv, q_offset = case
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (b, sq, hq, dk), dt)
    kj, kt = _pair(rng, (b, skv, hkv, dk), dt)
    vj, vt = _pair(rng, (b, skv, hkv, dv), dt)
    want = T.get("causal")(qj, kj, vj, q_offset=q_offset, block_q=32,
                           block_k=32, interpret=True)
    got = ops.attention_core(qt, kt, vt, q_offset=q_offset)
    assert got.shape == (b, sq, hq, dv) and got.dtype == TORCH_DT[dt]
    _close(got, want, dt)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_core_matches_pallas(hq, hkv, dt):
    rng = np.random.default_rng(3)
    b, t, d = 4, 40, 32
    qj, qt = _pair(rng, (b, 1, hq, d), dt)
    kj, kt = _pair(rng, (b, t, hkv, d), dt)
    vj, vt = _pair(rng, (b, t, hkv, d), dt)
    lengths = np.array([1, 17, 40, 0], np.int32)     # 0: a dead slot
    want = jops.attn_decode_template(qj, kj, vj, jnp.asarray(lengths),
                                     interpret=True)
    got = ops.decode_core(qt, kt, vt, torch.from_numpy(lengths))
    assert got.shape == (b, 1, hq, d) and got.dtype == TORCH_DT[dt]
    _close(got, want, dt)
    assert not got[3].float().abs().any(), "lengths 0 must give exact zeros"


def test_cpu_branch_launches_nothing():
    ops.reset_launches()
    x = torch.randn(3, 64)
    ops.rms_norm(x, torch.ones(64))
    ops.swiglu(x, x)
    assert all(n == 0 for n in ops.launches.values())


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device_mix"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.randn(4, 64)
    w = torch.ones(64)
    if bad == "dtype":
        with pytest.raises(TypeError):
            ops.rms_norm(x.half(), w.half())
    elif bad == "contiguity":
        with pytest.raises(ValueError):
            ops.swiglu(x.t(), x.t())
    elif bad == "shape":
        with pytest.raises(ValueError):
            ops.rms_norm(x, torch.ones(65))
    else:
        with pytest.raises(ValueError):
            ops.decode_core(torch.randn(2, 1, 4, 8), torch.randn(2, 5, 4, 8),
                            torch.randn(2, 5, 4, 8),
                            torch.tensor([1, 2], dtype=torch.int64))
