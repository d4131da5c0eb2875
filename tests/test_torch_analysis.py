"""The port's invariant linter (``repro_torch.analysis``) against the JAX
package's.

* the pure helpers (``forbidden_weight_shapes``,
  ``expected_dispatch_count``, ``_default_packed_threshold``) equal the
  reference's over every shipped config × bit mix × phase × ``fused``;
* ``forbidden_shapes_from_qparams`` on the port's full-size meta stores
  equals the reference's on ``jax.eval_shape`` stores (smoke configs);
* ``build_targets`` gives the reference's target names, and a target's
  kernel calls over its layer bodies and steps equal the ``pallas_call``
  count of the reference's jaxpr for it (walked by duck typing: the
  installed jax has no ``jax.core.ClosedJaxpr``, which is what breaks the
  reference's own walker, so its findings are not compared);
* a full-size decode step on meta makes the kernel calls the card counts
  for qwen3_0p6b, zamba2_1p2b and falcon_mamba_7b (84, 76, 128);
* every rule fires on the port's analogue of the reference's seeded
  violation (``tests/test_analysis.py``), with a ``file:line`` in
  ``src/repro_torch``, and stays silent on the healthy path;
* the reduced smoke configs, ``_ep`` targets included, lint clean on
  ``meta`` and on the CPU.
"""
import dataclasses
import functools

import jax
import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread a worker)
from repro.analysis import lint as jlint
from repro.analysis import rules as jrules
from repro.configs import get_config as jget_config
from repro_torch.analysis import LintTarget, RULES, count_kernel_calls, \
    expected_dispatch_count, forbidden_weight_shapes, run_rules, trace_ops
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import rules as trules
from repro_torch.analysis.resources import INSTANTIATIONS, KernelResources, \
    SMEM_BUDGET_BYTES, instantiation_smem, kernel_smem_bytes, \
    launch_smem_bytes, parse_ptxas
from repro_torch.configs import ANALYSIS_SMOKE_CONFIGS, ARCH_IDS, get_config
from repro_torch.models import model as tmodel
from repro_torch.models.config import DyMoEPolicy, ModelConfig
from repro_torch.models.layers.moe import moe_apply_rows
from repro_torch.quant import MixedPrecisionWeights, mixed_precision_matmul
from repro_torch.serving.scheduler import live_cap_for

MIXES = ("mixed", "4/0")


# ------------------------------------------------ the reference's helpers


@pytest.mark.parametrize("name", ARCH_IDS)
def test_pure_helpers_equal_the_reference(name):
    for mix in MIXES:
        cfg = tlint._mix_cfg(get_config(name), mix)
        jcfg = jlint._mix_cfg(jget_config(name), mix)
        assert forbidden_weight_shapes(cfg) == \
            jrules.forbidden_weight_shapes(jcfg)
        assert trules._default_packed_threshold(cfg) == \
            jrules._default_packed_threshold(jcfg)
        for phase in ("prefill", "admission", "decode_chunk"):
            for fused in (True, False):
                assert expected_dispatch_count(
                    cfg, phase=phase, fused=fused) == \
                    jrules.expected_dispatch_count(jcfg, phase=phase,
                                                   fused=fused)


@pytest.mark.parametrize("name", ANALYSIS_SMOKE_CONFIGS)
def test_forbidden_shapes_of_full_size_stores(name):
    """The port's stores on meta (full size, no memory) against the
    reference's ``eval_shape`` stores."""
    _, jq = jlint._abstract_state(jget_config(name))
    _, q = tlint._state(get_config(name), torch.device("meta"))
    got = tlint.forbidden_shapes_from_qparams(q)
    assert got and got == jlint.forbidden_shapes_from_qparams(jq)


# ------------------------------------------------ targets and dispatches


@functools.lru_cache(maxsize=None)
def _reference_targets(name):
    return jlint.build_targets(name, jget_config(name).reduced())


@functools.lru_cache(maxsize=None)
def _port_targets(name, device):
    return tlint.build_targets(name, get_config(name).reduced(),
                               device=device)


def _subjaxprs(v):
    if hasattr(v, "eqns"):
        return [v]
    if hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
        return [v.jaxpr]
    if isinstance(v, (list, tuple)):
        return [s for x in v for s in _subjaxprs(x)]
    return []


def _pallas_calls(jaxpr) -> int:
    """``pallas_call`` equations of a jaxpr, recursing into sub-jaxprs but
    not into kernel bodies (a scan body counts once)."""
    n = 0
    for eqn in _subjaxprs(jaxpr)[0].eqns:
        if eqn.primitive.name == "pallas_call":
            n += 1
            continue
        for v in eqn.params.values():
            n += sum(_pallas_calls(s) for s in _subjaxprs(v))
    return n


@pytest.mark.parametrize("name", ANALYSIS_SMOKE_CONFIGS)
def test_target_names_and_dispatches_equal_the_reference(name):
    ref = _reference_targets(name)
    mine = _port_targets(name, "meta")
    assert [t.name for t in mine] == [t.name for t in ref]
    checked = 0
    for t, r in zip(mine, ref):
        if r.jaxpr is None:     # the retrace target; the reference's _ep
            continue            # traces fail on the installed jax
        assert t.trace is not None, t.trace_error
        calls = count_kernel_calls(t.trace)
        assert calls % t.layer_steps == 0, (t.name, calls, t.layer_steps)
        assert calls // t.layer_steps == _pallas_calls(r.jaxpr), t.name
        checked += 1
    assert checked >= 3


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("name", ANALYSIS_SMOKE_CONFIGS)
def test_reduced_smoke_configs_lint_clean(name, device):
    targets = _port_targets(name, device)
    assert len(targets) >= 5
    ep = [t for t in targets if t.phase.endswith("_ep")]
    assert bool(ep) == get_config(name).is_moe
    findings = tlint.lint_targets(targets)
    assert not findings, [f.to_json() for f in findings]


# the card's K2 launches a decode step at full size (ROADMAP contract 1)
CARD_COUNTS = {"qwen3_0p6b": 84, "zamba2_1p2b": 76, "falcon_mamba_7b": 128}


@pytest.mark.parametrize("name", sorted(CARD_COUNTS))
def test_full_size_decode_step_kernel_calls_match_the_card(name):
    """One full-size decode step on meta: the kernel calls the card
    counts, and the budget rule (a hybrid's shared sites adding none)
    agrees."""
    cfg = get_config(name)
    meta = torch.device("meta")
    params, qparams = tlint._state(cfg, meta)
    caches = tmodel.init_decode_state(cfg, 2, 16, meta)
    tok = torch.zeros((2,), dtype=torch.int32, device=meta)
    _, trace = trace_ops(lambda: tmodel.decode_step(
        params, cfg, tok, caches, qparams=qparams))
    assert count_kernel_calls(trace) == CARD_COUNTS[name]
    assert count_kernel_calls(trace, "expert_quant_matmul") == \
        CARD_COUNTS[name]
    assert not run_rules(_target(cfg, trace, device="meta",
                                 layer_steps=cfg.num_layers),
                         only=["kernel-dispatch-budget"])


# ------------------------------------------------------ seeded violations


def _cfg(low_bits=2):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=1, d_model=32, vocab_size=64,
        num_heads=2, num_kv_heads=2, head_dim=16, num_experts=4,
        num_experts_per_tok=2, moe_d_ff=48, capacity_factor=2.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, group_size=16))


def _target(cfg, trace, phase="decode_chunk", **kw):
    kw.setdefault("device", "cpu")
    return LintTarget(name=f"fixture/{phase}", cfg=cfg, phase=phase,
                      trace=trace, **kw)


def _expert_setup(seed=0):
    cfg = _cfg()
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((cfg.num_experts, cfg.d_model, cfg.expert_d_ff),
                    generator=g)
    mp = MixedPrecisionWeights.build(w, 4, 2, 16)
    crit = torch.tensor([True, False, True, False])
    x = torch.randn((cfg.num_experts, 8, cfg.d_model), generator=g)
    return cfg, mp, crit, x


def test_no_dense_dequant_fires_on_materialize_with_its_line():
    cfg, mp, crit, x = _expert_setup()
    shape = (cfg.num_experts, cfg.d_model, cfg.expert_d_ff)
    _, trace = trace_ops(
        lambda: mixed_precision_matmul(x, mp, crit, materialize=True,
                                       out_dtype=torch.float32),
        watch_shapes=forbidden_weight_shapes(cfg))
    findings = run_rules(_target(cfg, trace), only=["no-dense-dequant"])
    assert findings, "dense dequant materialization not caught"
    f = findings[0]
    assert f.rule == "no-dense-dequant" and f.severity == "error"
    assert str(shape) in f.message
    assert "src/repro_torch/quant/" in f.provenance, f.provenance
    # the packed path: the codes widen inside the kernel call only
    _, clean = trace_ops(lambda: mixed_precision_matmul(
        x, mp, crit, out_dtype=torch.float32))
    assert count_kernel_calls(clean) == 1
    assert not run_rules(_target(cfg, clean), only=["no-dense-dequant"])
    assert any(s.in_kernel for s in clean.sites)


def _moe_layer(cfg):
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    qparams = tmodel.quantize_model(params, cfg)
    return (tmodel._index_tree(params["layers"], 0)["moe"],
            tmodel._index_tree(qparams["layers"], 0)["moe"])


def test_dispatch_budget_fires_on_dual_path_claiming_fused():
    cfg = _cfg()
    p, qw = _moe_layer(cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((8, cfg.d_model), generator=g)
    crit = torch.rand((8, cfg.num_experts), generator=g) < 0.5

    def run(fused):
        return trace_ops(lambda: moe_apply_rows(
            p, cfg, x, crit, qweights=qw, fused=fused)[0])[1]

    dual = run(False)
    assert count_kernel_calls(dual) == 6
    findings = run_rules(_target(cfg, dual, fused=True),
                         only=["kernel-dispatch-budget"])
    assert len(findings) == 1
    assert "6 kernel calls" in findings[0].message \
        and "exactly 3" in findings[0].message
    assert "src/repro_torch/models/layers/moe.py" in findings[0].provenance
    assert not run_rules(_target(cfg, run(True), fused=True),
                         only=["kernel-dispatch-budget"])
    # over two layer bodies the same trace is short by three
    assert run_rules(_target(cfg, run(True), layer_steps=2),
                     only=["kernel-dispatch-budget"])


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN7eqm_mma14grouped_kernelI13__nv_bfloat16Li1EEEvPKT_PKhPKfS6_S8_PKiPviiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN7eqm_mma14grouped_kernelI13__nv_bfloat16Li1EEEvPKT_PKhPKfS6_S8_PKiPviiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN7eqm_mma14grouped_kernelIfLi4EEEvPKT_PKhPKfS6_S8_PKiPviiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN7eqm_mma14grouped_kernelIfLi4EEEvPKT_PKhPKfS6_S8_PKiPviiiiiiiii
    16 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 64 bytes smem, 400 bytes cmem[0]
"""


def test_kernel_resources_fires_on_a_spill_and_an_oversized_smem():
    cfg, mp, crit, x = _expert_setup()
    res = parse_ptxas(_PTXAS, "eqm_grouped")
    assert [r.name for r in res] == ["eqm_grouped:grouped_kernel<bf16,1>",
                                     "eqm_grouped:grouped_kernel<f32,4>"]
    assert res[1] == KernelResources("eqm_grouped:grouped_kernel<f32,4>",
                                      255, 64, 24, 20)
    findings = run_rules(_target(cfg, None, resources=res),
                         only=["kernel-resources"])
    assert len(findings) == 1 and "spills 24 B" in findings[0].message
    big = KernelResources("eqm_expert:expert_kernel<f32,4>", 200,
                          SMEM_BUDGET_BYTES["sm_90a"] + 1, 0, 0)
    assert run_rules(_target(cfg, None, resources=[big]),
                     only=["kernel-resources"])
    # a kernel call whose mirrored dynamic shared memory exceeds a budget
    _, trace = trace_ops(lambda: mixed_precision_matmul(
        x, mp, crit, out_dtype=torch.float32))
    assert not run_rules(_target(cfg, trace), only=["kernel-resources"])
    f = run_rules(_target(cfg, trace, smem_budget=16384),
                  only=["kernel-resources"])
    assert f and "expert_kernel<f32,1> asks 34816 B" in f[0].message
    assert "src/repro_torch/" in f[0].provenance
    # the C++ requesting another size than the mirror's
    wrong = {"eqm_grouped:grouped_kernel<bf16,1>": 1024}
    assert run_rules(_target(cfg, None, requested_smem=wrong),
                     only=["kernel-resources"])


def test_smem_mirror_covers_every_instantiation():
    sizes = kernel_smem_bytes()
    assert len(sizes) == sum(len(v) for v in INSTANTIATIONS.values()) == 26
    assert max(sizes.values()) <= SMEM_BUDGET_BYTES["sm_90a"]
    # the figures the kernels' sources state (score_tile.cuh users, D 128)
    assert instantiation_smem("flash_fwd_kernel<bf16,128>") == 85 * 1024
    assert instantiation_smem("flash_fwd_kernel<f32,128>") == 113152
    assert instantiation_smem("flash_fwd_kernel<f32,256>") == 219648
    assert instantiation_smem("key_mass_kernel<bf16,128>") == 52736
    assert instantiation_smem("grouped_kernel<bf16,1>") == 29696
    x = ((2, 100, 64), torch.bfloat16)
    assert launch_smem_bytes("flash_fwd", [x], {}) == (
        "flash_fwd_kernel<bf16,64>", instantiation_smem(
            "flash_fwd_kernel<bf16,64>"))
    assert launch_smem_bytes("expert_quant_matmul_grouped",
                             [((4, 32, 64), torch.float32)],
                             {"cap_hi": 16})[0] == "grouped_kernel<f32,1>"
    assert launch_smem_bytes("expert_quant_matmul_grouped",
                             [((4, 40, 64), torch.float32)],
                             {"cap_hi": 20})[0] == "grouped_kernel<f32,4>"


def test_dtype_discipline_fires_on_traced_f64_leak():
    cfg = _cfg()
    v = torch.zeros(4)
    _, trace = trace_ops(lambda: (v.to(torch.float64) * 2.0).sum())
    findings = run_rules(_target(cfg, trace, phase="prefill",
                                 packed_upcast_threshold=1 << 30),
                         only=["dtype-discipline"])
    assert findings and "f64" in findings[0].message
    assert "tests/" not in findings[0].provenance


def test_dtype_discipline_fires_on_packed_upcast_outside_kernel():
    cfg = _cfg()
    packed = torch.zeros((4, 48, 16), dtype=torch.uint8)
    _, trace = trace_ops(lambda: packed.to(torch.float32).sum())
    findings = run_rules(_target(cfg, trace, packed_upcast_threshold=1024),
                         only=["dtype-discipline"])
    assert findings and "packed codes" in findings[0].message
    # the same widening inside a kernel call (the plain version's unpack)
    # is the allowlisted path
    _, mp, crit, x = _expert_setup()
    _, kt = trace_ops(lambda: mixed_precision_matmul(
        x, mp, crit, out_dtype=torch.float32))
    assert not run_rules(_target(cfg, kt, packed_upcast_threshold=256),
                         only=["dtype-discipline"])


def _item_in_decode_chunk(monkeypatch):
    """``.item()`` of a device value inside every decode step."""
    real = tmodel._mask_info_rows

    def leaky(info, live):
        if bool(live.any().item()):
            pass
        return real(info, live)

    monkeypatch.setattr(tmodel, "_mask_info_rows", leaky)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_sync_fires_on_item_in_decode_chunk(monkeypatch, device):
    cfg = get_config("olmoe_1b_7b").reduced()
    mix = tlint._mix_cfg(cfg, "mixed")
    params, qparams = tlint._state(mix, torch.device(device))
    fn, args, steps = tlint._decode_program(mix, params, qparams,
                                            torch.device(device))
    _item_in_decode_chunk(monkeypatch)
    t = tlint.trace_target("fixture/decode_chunk", mix, "decode_chunk", fn,
                           args, steps, device=device)
    findings = tlint.lint_targets([t])
    sync = [f for f in findings if f.rule == "host-sync"]
    assert sync and sync[0].primitive == "host:item", findings
    assert "src/repro_torch/models/model.py" in sync[0].provenance
    # on meta the read itself raises: the run is a trace error too
    assert (device == "meta") == any(f.rule == "trace-error"
                                     for f in findings)


def test_host_reads_the_cpu_dispatches_nothing_for_are_seen():
    v = torch.arange(4)
    _, trace = trace_ops(lambda: (v.tolist(), v.numpy(), int(v[0])))
    assert [s.op for s in trace.sites if s.host_read] == [
        "host:tolist", "host:numpy", "host:__int__"]


def test_retrace_budget_fires_on_identity_ladder():
    cfg = _cfg()
    bad = LintTarget(name="fixture/retrace", cfg=cfg, phase="retrace",
                     slots=8, ladder=lambda n, b: n)
    findings = run_rules(bad, only=["retrace-budget"])
    assert len(findings) == 2
    assert any("non-power-of-two" in f.message for f in findings)
    assert any("log2(B)+1" in f.message for f in findings)
    good = dataclasses.replace(bad, ladder=live_cap_for)
    assert not run_rules(good, only=["retrace-budget"])


def test_rule_registry_ships_the_contract():
    assert set(RULES) == {"no-dense-dequant", "kernel-dispatch-budget",
                          "kernel-resources", "dtype-discipline",
                          "host-sync", "retrace-budget"}
    assert set(RULES) - set(jrules.RULES) == {"kernel-dispatch-budget",
                                              "kernel-resources"}


def test_scopes_count_nested_calls_once():
    cfg, mp, crit, x = _expert_setup()
    from repro_torch.kernels._scope import kernel_scope

    def outer():
        with kernel_scope("expert_quant_matmul", x) as ks:
            return ks.done(mixed_precision_matmul(x, mp, crit))

    _, trace = trace_ops(outer)
    kernels = [s for s in trace.sites if s.kernel]
    assert len(kernels) == 2 and kernels[1].path == ("expert_quant_matmul",)
    assert count_kernel_calls(trace) == 1
