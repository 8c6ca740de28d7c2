"""The compiled view (``repro_torch/core/compiled.py``) on the CPU.

A reduced llama2-7b (2 layers, d_model 256, 4 heads) on weights bridged
from JAX's ``init_lm`` goes through ``torch.compile`` under
``nn.backend("cuda")``: on CPU tensors the kernel wrappers take their
plain versions inside the custom ops, so the compiled graph holds the same
opaque ``repro_torch::`` calls it holds on the card. Its logits, unfused
and under ``nn.fuse()``, are held to JAX's ``lm_forward`` (Pallas in
interpret mode) within ``tests/test_kernels.py``'s ``_tol(f32)``.
``fusion_group`` is held to ``repro.core.hlo._fusion_group`` on small HLO
texts parsed by JAX's own parser. The profile of the unfused compile:
groups that sum to the total, the extern ``mm`` GEMM, the rms_norm op
NORMALIZATION, the residual add's carried tag, no kernel unattributed. A
graph break raises, and ``torch.library.opcheck`` passes for the kernel
ops the compiled forwards call. Each config compiles once (a module
fixture): an Inductor compile costs seconds on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import nn as jnn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import hlo as jhlo  # noqa: E402
from repro.core.taxonomy import classify_hlo as jclassify_hlo  # noqa: E402
from repro.models import init_lm as jinit_lm  # noqa: E402
from repro.models import lm_forward as jlm_forward  # noqa: E402

from repro_torch import bridge, nn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (OpGroup, QuantizeDequantTransform,  # noqa: E402
                              Workload)
from repro_torch.core import compiled as C  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm_forward  # noqa: E402

#: tests/test_kernels.py ``_tol(jnp.float32)``
F32_TOL = 2e-5
ARCH = "llama2-7b"


@pytest.fixture(scope="module")
def llama():
    jcfg = jreduced(jget_config(ARCH)).replace(n_layers=2)
    cfg = reduced(get_config(ARCH)).replace(n_layers=2)
    jparams = jinit_lm(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    return jcfg, cfg, jparams, params, toks


def _forward(cfg):
    def fwd(params, tokens):
        return lm_forward(params, tokens, cfg)
    return fwd


@pytest.fixture(scope="module")
def compiled(llama):
    """``(fn, args, CompiledForward)`` per fused, each compiled once under
    the kernel backend."""
    _, cfg, _, params, toks = llama
    memo = {}

    def get(fused):
        if fused not in memo:
            fn, args = _forward(cfg), (params, torch.from_numpy(toks))
            with nn.backend("cuda"), nn.fuse(fused):
                memo[fused] = fn, args, C.compile_forward(fn, *args)
        return memo[fused]
    return get


@pytest.fixture(scope="module")
def profile(compiled):
    fn, args, cf = compiled(False)
    with nn.backend("cuda"):
        return C.measure(cf, fn, args, name="llama", device="cpu", repeats=2)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_compiled_forward_gives_jax_logits(llama, compiled, fused):
    jcfg, cfg, jparams, _, toks = llama
    with jnn.backend("pallas_interpret"), jnn.fuse(fused):
        want = jax.jit(lambda p, t: jlm_forward(p, t, jcfg))(
            jparams, jnp.asarray(toks, jnp.int32))
    fn, args, cf = compiled(fused)
    assert cf.output.shape == (2, 8, cfg.vocab_size)
    np.testing.assert_allclose(cf.output.numpy(), np.asarray(want),
                               atol=F32_TOL)
    # the kernels stay opaque calls: the fused forward calls rope and the
    # fused-add norm, the unfused one neither
    names = set(cf.ops)
    assert {"repro_torch::rms_norm", "repro_torch::attention_core",
            "repro_torch::swiglu"} <= names
    assert ({"repro_torch::rope", "repro_torch::fused_add_rms_norm"}
            <= names) == fused
    # a second call runs the same program: no launch is counted on the CPU
    ops.reset_launches()
    with nn.backend("cuda"), nn.fuse(fused), \
            torch._dynamo.config.patch(error_on_recompile=True):
        again = cf(*args)
    assert torch.equal(again, cf.output)
    assert not any(ops.launches.values())


def test_tags_carried_into_the_compiled_graph(compiled):
    """All but the graph's untagged glue carry an ``ng:`` site."""
    _, _, cf = compiled(False)
    assert cf.graph_nodes > 100
    assert cf.tagged_nodes >= cf.graph_nodes - 5, \
        (cf.tagged_nodes, cf.graph_nodes)


def test_profile_groups_sum_and_attribute(profile, compiled):
    p = profile
    assert p.mode == "compiled_cpu" and p.name == "llama"
    assert sum(p.group_seconds.values()) == pytest.approx(p.total_seconds)
    assert sum(p.op_seconds.values()) == pytest.approx(p.total_seconds)
    launches = p.compiled["launches"]
    assert p.n_ops == sum(launches.values()) > 0
    assert p.compiled["wall_s"] > 0 and p.compiled["compile_s"] > 0
    assert p.compiled["guard"]["max_abs_diff"] <= F32_TOL
    kernels = {k: g for g, k in p.op_seconds}
    assert kernels["aten::mm"] == "gemm"
    assert kernels["repro_torch::rms_norm"] == "normalization"
    assert kernels["repro_torch::attention_core"] == "gemm"
    assert kernels["repro_torch::swiglu"] == "activation"
    # 2 norms a layer and the final one, one launch each
    assert launches["repro_torch::rms_norm"] == 5
    assert OpGroup.OTHER.value not in p.group_seconds, p.op_seconds
    # the residual add is fused into an Inductor kernel, where it votes
    # with its carried tag
    _, _, cf = compiled(False)
    voting = [k for k, votes in cf.kernels.items()
              if (OpGroup.ELEMENTWISE, True) in votes]
    assert voting and set(voting) <= set(launches)


def test_profile_row_and_breakdown_line(profile):
    from repro_torch.core import report
    row = report.profile_row(profile)
    assert row["busy_frac"] == pytest.approx(
        profile.total_seconds / profile.compiled["wall_s"])
    assert row["other_kernels"] == []
    text = report.render_breakdown_rows([row])
    assert "torch.compile-fused, measured on cpu" in text


def test_workload_backend_compiles_and_refuses_a_spec():
    """``Workload.profile("compiled")`` on a tiny builder, the plain
    backend (no custom op): every kernel an Inductor one or an extern
    product; under the QDQ transform, the quantization group too. The
    port measures: a hardware spec is refused."""
    def builder(w, device):
        g = torch.Generator(device).manual_seed(0)
        x = torch.randn((w.batch, w.seq, 32), generator=g, device=device)
        w1 = torch.randn((32, 64), generator=g, device=device) * 0.1

        def tiny(p, x):
            return nn.gelu(nn.residual_add(nn.linear(x, p), 1.0))
        return tiny, (x,), w1

    w = Workload(name="tiny", arch="tiny", batch=2, seq=8, builder=builder)
    p = w.profile("compiled", device="cpu", repeats=1)
    assert p.mode == "compiled_cpu"
    assert p.group_seconds.get("gemm", 0) > 0
    assert set(p.group_seconds) <= {"gemm", "activation", "elementwise"}
    with pytest.raises(ValueError, match="no ':<param>'"):
        w.profile("compiled:h100", device="cpu")
    # the QDQ transform changes the function that is compiled: its
    # quantize-dequantize chains are fused kernels of their own group
    q = w.with_transform(QuantizeDequantTransform("int8")).profile(
        "compiled", device="cpu", repeats=1)
    assert q.group_seconds.get("quantization", 0) > 0


def test_graph_break_raises():
    def broken(x):
        y = x + 1
        torch._dynamo.graph_break()
        return y * 2

    with pytest.raises(torch._dynamo.exc.Unsupported):
        C.compile_forward(broken, torch.ones(4))


# ---------------------------------------------------------------------------
# the vote against repro.core.hlo._fusion_group
# ---------------------------------------------------------------------------

def _hlo(body: str) -> str:
    return f"""\
HloModule vote, entry_computation_layout={{(f32[8]{{0}})->f32[8]{{0}}}}

%fused_computation (p0: f32[8]) -> f32[8] {{
{body}
}}

ENTRY %main (arg: f32[8]) -> f32[8] {{
  %arg = f32[8]{{0}} parameter(0)
  ROOT %fusion = f32[8]{{0}} fusion(%arg), kind=kLoop, calls=%fused_computation
}}
"""


def _op(name, opcode, operand, op_name=None, root=False):
    meta = f', metadata={{op_name="{op_name}"}}' if op_name else ""
    return (f"  {'ROOT ' if root else ''}%{name} = f32[8]{{0}} "
            f"{opcode}(%{operand}){meta}")


P0 = "  %p0 = f32[8]{0} parameter(0)"
VOTE_CASES = {
    # two tagged normalization ops (4) against three untagged adds (3)
    "tagged_beats_untagged": [
        P0, _op("a", "exponential", "p0", "m/ng:normalization:rms_norm/exp"),
        _op("b", "negate", "a", "m/ng:normalization:rms_norm/neg"),
        _op("c", "add", "b", "m/add"), _op("d", "add", "c", "m/add"),
        _op("e", "add", "d", "m/add", root=True)],
    # untagged interiors only: the opcodes' groups
    "untagged": [
        P0, _op("a", "exponential", "p0"), _op("b", "add", "a"),
        _op("c", "multiply", "b", root=True)],
    # a tie (2 each): the group counted first
    "tie_first_counted": [
        P0, _op("a", "exponential", "p0", "m/ng:activation:gelu/exp"),
        _op("b", "add", "a", "m/ng:elementwise:residual_add/add",
            root=True)],
    "tie_other_order": [
        P0, _op("a", "add", "p0", "m/ng:elementwise:residual_add/add"),
        _op("b", "exponential", "a", "m/ng:activation:gelu/exp",
            root=True)],
    # OTHER and CONTROL do not vote
    "only_other_and_control": [
        P0, _op("a", "custom-call", "p0"),
        _op("b", "rng-bit-generator", "a"), _op("c", "tuple", "b", root=True)],
    # nothing but the parameter: no vote
    "empty": ["  ROOT %p0 = f32[8]{0} parameter(0)"],
}


@pytest.mark.parametrize("case", sorted(VOTE_CASES))
def test_fusion_group_equals_jax(case):
    comps, entry = jhlo.parse_computations(_hlo("\n".join(VOTE_CASES[case])))
    fusion = next(i for i in comps[entry].instrs if i.opcode == "fusion")
    sub = comps[jhlo._CALLS_RE.search(fusion.attrs).group(1)]
    want = jhlo._fusion_group(fusion, comps)
    votes = [(OpGroup(jclassify_hlo(i.opcode, i.op_name)[0].value),
              "ng:" in i.op_name) for i in sub.instrs]
    assert C.fusion_group(votes).value == want.value
    if case == "tagged_beats_untagged":
        assert want.value == "normalization"
    if case.startswith("tie"):
        assert want.value == votes[1][0].value       # after the parameter
    if case in ("only_other_and_control", "empty"):
        assert want.value == "other"


def test_fusion_group_of_no_origins_is_other():
    assert C.fusion_group([]) is OpGroup.OTHER


# ---------------------------------------------------------------------------
# the custom ops' fakes
# ---------------------------------------------------------------------------

def _r(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


OPCHECK = {
    "rms_norm": lambda: (ops.rms_norm, (_r(2, 5, 32), _r(32, seed=1))),
    "layer_norm": lambda: (ops.layer_norm,
                           (_r(2, 5, 32), _r(32, seed=1), _r(32, seed=2))),
    "fused_add_rms_norm": lambda: (ops.fused_add_rms_norm,
                                   (_r(2, 5, 32), _r(2, 5, 32, seed=1),
                                    _r(32, seed=2))),
    "fused_add_layer_norm": lambda: (ops.fused_add_layer_norm,
                                     (_r(2, 5, 32), _r(2, 5, 32, seed=1),
                                      _r(32, seed=2), _r(32, seed=3))),
    "swiglu": lambda: (ops.swiglu, (_r(2, 5, 48), _r(2, 5, 48, seed=1))),
    "rope": lambda: (ops.rope, (_r(2, 5, 4, 16), torch.arange(
        5, dtype=torch.int32)[None].repeat(2, 1))),
    "attention_core": lambda: (ops.attention_core,
                               (_r(2, 5, 4, 16), _r(2, 5, 2, 16, seed=1),
                                _r(2, 5, 2, 8, seed=2))),
    "attention_full": lambda: (ops.attention_full,
                               (_r(2, 5, 4, 16), _r(2, 7, 2, 16, seed=1),
                                _r(2, 7, 2, 8, seed=2))),
}


@pytest.mark.parametrize("name", sorted(OPCHECK))
def test_kernel_op_fakes_pass_opcheck(name):
    op, args = OPCHECK[name]()
    torch.library.opcheck(op, args)
