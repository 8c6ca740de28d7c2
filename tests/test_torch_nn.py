"""The port's tagged nn ops against ``repro.nn``'s jnp ops, op by op, on the
same numpy inputs (f32, the JAX reference's CPU dtype), and their tags."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.core import capture  # noqa: E402

RNG = np.random.default_rng(0)
X4 = RNG.standard_normal((2, 5, 4, 16)).astype(np.float32)   # (B, S, H, D)
X3 = RNG.standard_normal((2, 5, 24)).astype(np.float32)
W = RNG.standard_normal((24, 12)).astype(np.float32)
POS = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
IDS = np.array([[3, 0, 9], [1, 1, 4]], np.int64)
TABLE = RNG.standard_normal((10, 6)).astype(np.float32)

# name: (port call, JAX call), each on its own framework's arrays
CASES = {
    "silu": (lambda t: tnn.silu(t(X3)), lambda j: jnn.silu(j(X3))),
    "scale": (lambda t: tnn.scale(t(X3), 0.37), lambda j: jnn.scale(j(X3), 0.37)),
    "softmax": (lambda t: tnn.softmax(t(X3) * 4, dim=-1),
                lambda j: jnn.softmax(j(X3) * 4, axis=-1)),
    "apply_rope": (lambda t: tnn.apply_rope(t(X4), t(POS)),
                   lambda j: jnn.apply_rope(j(X4), j(POS))),
    "apply_rope_fraction": (
        lambda t: tnn.apply_rope(t(X4), t(POS), base=500.0, fraction=0.25),
        lambda j: jnn.apply_rope(j(X4), j(POS), base=500.0, fraction=0.25)),
    "split_heads": (lambda t: tnn.split_heads(t(X3), 3),
                    lambda j: jnn.split_heads(j(X3), 3)),
    "merge_heads": (lambda t: tnn.merge_heads(t(X4)),
                    lambda j: jnn.merge_heads(j(X4))),
    "embedding_lookup": (lambda t: tnn.embedding_lookup(t(TABLE), t(IDS)),
                         lambda j: jnn.embedding_lookup(j(TABLE), j(IDS))),
    "residual_add": (lambda t: tnn.residual_add(t(X3), t(X3[::-1].copy())),
                     lambda j: jnn.residual_add(j(X3), j(X3[::-1].copy()))),
    "linear": (lambda t: tnn.linear(t(X3), t(W)), lambda j: jnn.linear(j(X3), j(W))),
    "einsum": (lambda t: tnn.einsum("bsd,df->bfs", t(X3), t(W)),
               lambda j: jnn.einsum("bsd,df->bfs", j(X3), j(W))),
    "rms_norm": (lambda t: tnn.rms_norm(t(X3), t(W[:, 0])),
                 lambda j: jnn.rms_norm(j(X3), j(W[:, 0]))),
    "swiglu": (lambda t: tnn.swiglu(t(X3), t(X3 * 0.5)),
               lambda j: jnn.swiglu(j(X3), j(X3 * 0.5))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nn_op_matches_jax_op(name):
    port, jax_op = CASES[name]
    with tnn.backend("torch"), jnn.backend("jnp"):
        got = port(torch.from_numpy)
        want = jax_op(jnp.asarray)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_tagged_ops_push_tag_and_call_marker():
    x = torch.ones(3)
    recs = capture(lambda: tnn.residual_add(tnn.silu(x), x))
    scopes = [r.scope for r in recs]
    assert scopes[0].startswith("ng:activation:silu/c")
    assert scopes[-1].startswith("ng:elementwise:residual_add/c")
    assert scopes[0].split("/")[1] != scopes[-1].split("/")[1]
    assert tnn.scope_path() == ""
