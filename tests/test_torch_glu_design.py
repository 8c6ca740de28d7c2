"""The gated activations' launch plan and arithmetic, held against the JAX
package on the CPU.

``csrc/swiglu.cu`` runs the plan ``repro_torch.kernels.swiglu.glu_plan``
picks from the sizes alone: ``grid`` CTAs of ``threads`` threads, thread
i taking vector i of ``width`` elements of each operand and element
n // width * width + i of the last partial vector. Its properties are
checked over a grid of sizes by emulating the kernel's indexing with numpy
index arithmetic.

The kernel computes both activations with one exponential and one
reciprocal an element, by the exact identities silu(g) = g / (1 + e^-g)
and 0.5 (1 + tanh(z)) = 1 / (1 + e^-2z). That arithmetic is emulated here
in numpy f32, one rounded operation at a time, and held against the
Pallas kernels ``repro.kernels.swiglu.swiglu`` / ``geglu`` in interpret
mode and against the port's plain version, on the same numpy inputs,
finite extremes of the gate included.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import swiglu as jglu  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import swiglu as glu  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)
#: the main path's sizes: llama2-7b's and gemma3-27b's decode steps, the
#: s16 profiles and the served prefills
MAIN = [4 * 11008, 4 * 21504, 16 * 11008, 16 * 21504, 256 * 11008,
        2048 * 21504]
SIZES = [1, 7, 8, 9, 127, 128, 129, *MAIN, (1 << 22) + 3]
# |emulation - reference| <= atol + rtol * |reference|: chip_smoke.py's TOL
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (3e-2, 2 ** -7)}


# -- the plan ----------------------------------------------------------------

def _coverage(n, p):
    """How often the kernel's threads write each element under plan ``p``:
    thread i of the grid (i < grid * threads) takes vector i below nv = n
    // width, its ``width`` elements, and element nv * width + i below n."""
    nv = n // p.width
    i = np.arange(p.grid * p.threads, dtype=np.int64)
    v = i[i < nv]
    elems = (v[:, None] * p.width + np.arange(p.width)).ravel()
    tail = nv * p.width + i
    return np.bincount(np.concatenate([elems, tail[tail < n]]), minlength=n)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("vec", [True, False])
def test_glu_plan_properties(n, dt, vec):
    p = glu.glu_plan(n, dt, vec)
    # the width respects vec: ACCESS_BYTES where the pointers allow it,
    # one element otherwise
    assert p.width == (glu.ACCESS_BYTES // dt.itemsize if vec else 1)
    # an instantiation the C entry has, and no CTA without a vector
    assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
    nv = n // p.width
    assert p.grid * p.threads >= nv and (p.grid - 1) * p.threads < max(nv, 1)
    assert 1 <= p.grid < 1 << 31
    # every element exactly once
    assert (_coverage(n, p) == 1).all()


def test_glu_plan_reads_no_tensor():
    """The plan's arguments are a size, a dtype and a flag: it reads no
    tensor, so it cannot wait on the card, and a meta tensor, which holds
    no data, plans as a real one."""
    assert list(inspect.signature(glu.glu_plan).parameters) == ["n", "dtype", "vec"]
    g = torch.empty((2048, 21504), dtype=torch.bfloat16, device="meta")
    assert glu.plan_for(g, g) == glu.glu_plan(g.numel(), g.dtype, True)


@pytest.mark.parametrize("n,dt,want", [
    (4 * 11008, torch.bfloat16, (4, 128, 86)),            # llama2-7b decode
    (4 * 21504, torch.bfloat16, (4, 128, 168)),           # gemma3-27b decode
    (256 * 11008, torch.bfloat16, (4, 128, 5504)),        # llama2-7b prefill
    (2048 * 21504, torch.bfloat16, (4, 128, 86016)),      # gemma3-27b prefill
    (4 * 11008, torch.float32, (2, 128, 172)),
    (3, torch.bfloat16, (4, 128, 1)),                     # the tail alone
])
def test_glu_plan_at_the_main_path_shapes(n, dt, want):
    assert tuple(glu.glu_plan(n, dt, True)) == want


def test_a_misaligned_view_plans_the_scalar_body():
    p = glu.glu_plan(4 * 11008 - 1, torch.bfloat16, False)
    assert p.width == 1 and p.grid * p.threads >= 4 * 11008 - 1


# -- the arithmetic ----------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)
GELU_ARG = np.float32(-2.0 * 0.7978845608028654 * 1.4426950408889634)
#: finite extremes of the gate: e^-g and e^-2z overflow, g^3 overflows,
#: the denominator passes 2^126 (-87.5 for SiLU, -9.7 for GeLU)
EXTREMES = [1e-30, -1e-30, 20.0, -20.0, -88.8, 100.0, -100.0, 1e4, -1e4,
            1e13, -1e13, -87.5, -9.7]


def _fdividef(x, y):
    """__fdividef: x times the reciprocal of y, 0 where |y| > 2^126."""
    with np.errstate(divide="ignore", over="ignore"):
        r = np.where(np.abs(y) > np.float32(2.0 ** 126), np.float32(0),
                     np.float32(1) / y).astype(np.float32)
    return (x * r).astype(np.float32)


def _emulate(kernel, g, u):
    """The kernel's f32 arithmetic on f32 numpy inputs, one rounded
    operation at a time (nvcc may fuse the cubic's last multiply-add: one
    rounding fewer)."""
    one = np.float32(1)
    with np.errstate(over="ignore", invalid="ignore"):
        if kernel == "swiglu":
            arg = -LOG2E * g
        else:
            arg = GELU_ARG * (g + np.float32(0.044715) * g * g * g)
        e = np.exp2(arg.astype(np.float32)).astype(np.float32)
    return _fdividef(g, one + e) * u


def _inputs(seed, kind):
    """(gate, up): random (scale 3, 1); the same with EXTREMES in two rows;
    or the gate swept over [-8, 8] against ups of +-8 (chip_smoke.py's
    sweep, which an approximate tanh fails at f32)."""
    rng = np.random.default_rng(seed)
    if kind == "sweep":
        g = np.linspace(-8, 8, 1 << 16, dtype=np.float32).reshape(256, 256)
        return g, np.where(rng.random(g.shape) < 0.5, -8, 8).astype(np.float32)
    g = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
    u = rng.standard_normal((8, 64)).astype(np.float32)
    if kind == "extremes":
        g[0, :len(EXTREMES)] = EXTREMES
        g[1, :len(EXTREMES)] = EXTREMES[::-1]
    return g, u


def _close(got, want, dtname):
    atol, rtol = TOL[dtname]
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.isfinite(got).all()
    assert (err <= atol + rtol * np.abs(want)).all(), float(err.max())


@pytest.mark.parametrize("kernel", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtname", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "extremes", "sweep"])
def test_glu_identities_against_jax_and_plain(kernel, dtname, kind):
    g, u = _inputs(0, kind)
    jdt = getattr(jnp, dtname)
    jg, ju = jnp.asarray(g).astype(jdt), jnp.asarray(u).astype(jdt)
    # the operands as the kernel reads them (rounded to the dtype)
    g32, u32 = (np.array(x.astype(jnp.float32)) for x in (jg, ju))
    emu = np.asarray(jnp.asarray(_emulate(kernel, g32, u32)).astype(jdt)
                     .astype(jnp.float32))
    want_jax = np.asarray(getattr(jglu, kernel)(jg, ju, interpret=True)
                          .astype(jnp.float32))
    tdt = getattr(torch, dtname)
    want_ref = getattr(ref, kernel)(torch.from_numpy(g32).to(tdt),
                                    torch.from_numpy(u32).to(tdt)).float().numpy()
    _close(emu, want_jax, dtname)
    _close(emu, want_ref, dtname)


def test_an_approximate_tanh_fails_the_sweep_at_f32():
    """The sweep's reason to be: GeLU through a tanh with a relative error
    of 2^-20 (tanh.approx.f32's is up to 2^-11) already passes the f32
    limit, where 1 + tanh(z) is small, while the identity stays within."""
    g, u = _inputs(0, "sweep")
    want = ref.geglu(torch.from_numpy(g), torch.from_numpy(u)).numpy()
    z = np.float32(0.7978845608028654) * (g + np.float32(0.044715) * g * g * g)
    t = np.tanh(z.astype(np.float64)) * (1 + 2.0 ** -20)
    approx = np.float32(0.5) * g * (np.float32(1) + t.astype(np.float32)) * u
    atol, rtol = TOL["float32"]
    assert (np.abs(approx - want) > atol + rtol * np.abs(want)).any()
    _close(_emulate("geglu", g, u), want, "float32")


def test_glu_identities_at_the_extremes_give_the_limits():
    """Where e^-g or e^-2z overflows the quotient is a zero of g's sign;
    where it underflows, g itself."""
    g = np.float32([-1e13, -1e4, -100.0, 1e13, 1e4, 100.0])
    u = np.ones_like(g)
    for kernel in ("swiglu", "geglu"):
        out = _emulate(kernel, g, u)
        assert (out[:3] == 0).all() and np.signbit(out[:3]).all()
        assert (out[3:] == g[3:]).all()
