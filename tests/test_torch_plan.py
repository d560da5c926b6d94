"""The port's planner (``repro_torch/plan.py``, ``core/model_math.py``)
against the JAX package's, on the CPU.

``model_math`` is pure arithmetic, so every public function must agree
exactly on a grid of arguments. For the same explicit ``HardwareSpec`` the
port's ``plan_run(...).to_json()`` must be the reference's byte for byte,
with ``explain()`` and the warnings, across the scenarios of
``tests/test_plan.py`` (roomy, HBM-starved, HBM- and DRAM-starved,
prefill, grad-accum, infeasible host params, no NVMe, ``min_device_mem``,
each override, ``param_quant``, the serving KV plans) and across train and
decode shapes of smollm-135m, llama3.2-3b and gemma-7b. Then the launchers'
``--plan auto`` on the CPU, where the port plans for the host
(``device="cpu"``) as the reference does on its CPU backend.
"""
import dataclasses
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.core import model_math as jmm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.config import ShapeConfig as TShape  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.core import model_math as tmm  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

# ---------------------------------------------------------------------------
# model_math: paper Eqs. 1-11
# ---------------------------------------------------------------------------

GRID_NL = (1, 2, 30, 96)
GRID_HD = (64, 576, 4096, 18432)
GRID_B_S = ((1, 1), (8, 512), (256, 4096), (1, 524288))


def _public(mod):
    return sorted(n for n, f in vars(mod).items()
                  if not n.startswith("_") and inspect.isfunction(f)
                  and f.__module__ == mod.__name__)


def test_model_math_has_every_public_function_and_constant():
    assert _public(tmm) == _public(jmm)
    for name in ("BYTES_PER_PARAM_MODEL_STATES", "BYTES_PER_PARAM_FP16",
                 "BYTES_PER_PARAM_OPT"):
        assert getattr(tmm, name) == getattr(jmm, name)
    for name in ("DGX2_NODE", "TPU_V5E_POD"):
        assert dataclasses.asdict(getattr(tmm, name)) == dataclasses.asdict(getattr(jmm, name))
    assert {k: dataclasses.asdict(v) for k, v in tmm.POLICIES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jmm.POLICIES.items()}


@pytest.mark.parametrize("nl", GRID_NL)
@pytest.mark.parametrize("hd", GRID_HD)
def test_model_math_equations_agree_exactly(nl, hd):
    for bsz, seq in GRID_B_S:
        for heads in (1, 9, 96):
            for ci in (1, 2, 4):
                assert tmm.activation_checkpoint_bytes(nl, hd, bsz, seq, ci) == \
                    jmm.activation_checkpoint_bytes(nl, hd, bsz, seq, ci)
                assert tmm.activation_working_memory_bytes(hd, bsz, seq, heads, ci) == \
                    jmm.activation_working_memory_bytes(hd, bsz, seq, heads, ci)
                assert tmm.ait_activation_checkpoints(hd, ci) == \
                    jmm.ait_activation_checkpoints(hd, ci)
            assert tmm.total_activation_bytes(nl, hd, bsz, seq, heads) == \
                jmm.total_activation_bytes(nl, hd, bsz, seq, heads)
        assert tmm.computation_per_iter(nl, hd, bsz, seq) == \
            jmm.computation_per_iter(nl, hd, bsz, seq)
        assert tmm.ait_params_grads(bsz, seq) == jmm.ait_params_grads(bsz, seq)
        assert tmm.ait_optimizer_states(bsz, seq) == jmm.ait_optimizer_states(bsz, seq)
    assert tmm.transformer_params(nl, hd) == jmm.transformer_params(nl, hd)
    assert tmm.model_states_bytes(nl, hd) == jmm.model_states_bytes(nl, hd)
    assert tmm.model_state_working_memory_bytes(hd) == jmm.model_state_working_memory_bytes(hd)


def test_model_math_efficiency_capacity_and_flops_agree_exactly():
    for ait in (1.0, 128.0, 4096.0 * 8, 1e6):
        for bw in (0.0, 1.6e9, 3e9, 3.35e12):
            for peak in (70e12, 989e12):
                assert tmm.efficiency(ait, bw, peak) == jmm.efficiency(ait, bw, peak)
                for eff in (0.1, 0.5, 0.9):
                    assert tmm.required_bandwidth(ait, peak, eff) == \
                        jmm.required_bandwidth(ait, peak, eff)
    for bad in (0.0, 1.0):
        for mod in (tmm, jmm):
            with pytest.raises(ValueError, match="target_eff"):
                mod.required_bandwidth(1.0, 1.0, bad)
    for name in tmm.POLICIES:
        for cl in ("DGX2_NODE", "TPU_V5E_POD"):
            for frac in (0.5, 0.7, 1.0):
                assert tmm.max_trainable_params(tmm.POLICIES[name], getattr(tmm, cl), frac) == \
                    jmm.max_trainable_params(jmm.POLICIES[name], getattr(jmm, cl), frac)
    for n in (1, 134515008, 3.2e9):
        for t in (1, 4096, 1e6):
            assert tmm.model_flops(n, t) == jmm.model_flops(n, t)
            assert tmm.decode_model_flops(n, t) == jmm.decode_model_flops(n, t)
    for x in (0, 1, 127, 128, 129, 1e9 + 0.5):
        for q in (1, 128, 512):
            assert tmm.hbm_roundup(x, q) == jmm.hbm_roundup(x, q)
    c = tmm.ClusterSpec(n_devices=64, device_mem=80e9, host_mem_per_node=1e12,
                        nvme_per_node=3e12, devices_per_node=8)
    j = jmm.ClusterSpec(n_devices=64, device_mem=80e9, host_mem_per_node=1e12,
                        nvme_per_node=3e12, devices_per_node=8)
    for prop in ("n_nodes", "aggregate_device_mem", "aggregate_host_mem", "aggregate_nvme"):
        assert getattr(c, prop) == getattr(j, prop)


def test_schedule_imports_the_fp16_constant_from_model_math():
    assert tsched.BYTES_PER_PARAM_FP16 is tmm.BYTES_PER_PARAM_FP16


@pytest.mark.parametrize("block_bytes,step_flops,bw,peak", [
    (1.0, 1.0, 1.6e9, 70e12), (3.5e6, 4 * 4 * 1.35e8, 3e9, 70e12),
    (2e9, 1e6, 1.6e9, 989e12), (0.0, 0.0, 0.0, 0.0), (1e5, 1e15, 1e9, 1e12)])
def test_kv_prefetch_blocks_equals_reference(block_bytes, step_flops, bw, peak):
    from repro.core import schedule as jsched

    assert tsched.default_kv_prefetch_blocks(block_bytes, step_flops, slow_bw=bw,
                                             peak_flops=peak) == \
        jsched.default_kv_prefetch_blocks(block_bytes, step_flops, slow_bw=bw,
                                          peak_flops=peak)


@pytest.mark.parametrize("arch", ["smollm-135m", "llama3.2-3b", "gemma-7b",
                                  "mamba2-370m", "recurrentgemma-9b", "llava-next-34b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("ctx", [16, 640, 32768])
def test_sequence_kv_bytes_equals_reference(arch, ctx):
    assert tkv.sequence_kv_bytes(tconfigs.get(arch), ctx) == \
        jkv.sequence_kv_bytes(jconfigs.get(arch), ctx)


# ---------------------------------------------------------------------------
# plan_run: byte-identical plans
# ---------------------------------------------------------------------------

_NVME = dict(n_devices=16, device_mem=1e9, host_mem=8e9, nvme_capacity=28e12)
_ROOMY = dict(n_devices=16, device_mem=32e9, host_mem=1.5e12, nvme_capacity=28e12)


def _serve_starved_hw():
    """Room for smollm's params and four 128-token sequences of KV."""
    sb = jplan.state_bytes(jconfigs.get("smollm-135m"), JShape("serve", 128, 16, "decode"), 1)
    per = jkv.sequence_kv_bytes(jconfigs.get("smollm-135m"), 128)
    return dict(n_devices=1, device_mem=(sb.param + 4 * per) / 0.7, host_mem=64e9)


# name -> (arch, shape: a SHAPES name or (seq, batch, kind), hardware, kw)
SCENARIOS = {
    "roomy": ("smollm-135m", "train_4k", _ROOMY, {}),
    "hbm_starved": ("smollm-135m", "train_4k",
                    dict(_ROOMY, device_mem=1e9), {}),
    "hbm_and_dram_starved": ("smollm-135m", "train_4k", _NVME, {}),
    "prefill_params_only": ("smollm-135m", (1024, 8, "prefill"),
                            dict(n_devices=1, device_mem=1.2e9, host_mem=2e9), {}),
    "grad_accum_odd_batch": ("smollm-135m", (4096, 6, "train"),
                             dict(n_devices=1, device_mem=50e6, host_mem=500e6,
                                  nvme_capacity=1e12), {}),
    "host_params_infeasible": ("smollm-135m", "train_4k",
                               dict(n_devices=1, device_mem=300e6, host_mem=2e12), {}),
    "host_params_escalate": ("smollm-135m", "train_4k",
                             dict(n_devices=1, device_mem=300e6, host_mem=2e12,
                                  nvme_capacity=28e12), {}),
    "no_nvme_no_room": ("smollm-135m", "train_4k",
                        dict(n_devices=1, device_mem=1e6, host_mem=1e6), {}),
    "min_device_mem": ("smollm-135m", "train_4k", _ROOMY,
                       {"objective": "min_device_mem"}),
    "override_opt_device": ("smollm-135m", "train_4k",
                            dict(_NVME, n_devices=1), {"overrides": {"opt_tier": "device"}}),
    "override_pjit_nvme": ("smollm-135m", "train_4k", _NVME,
                           {"overrides": {"engine": "pjit"}}),
    "override_param_nvme": ("smollm-135m", "train_4k", _ROOMY,
                            {"overrides": {"param_tier": "nvme"}}),
    "override_window_auto": ("smollm-135m", "train_4k", _NVME,
                             {"overrides": {"prefetch_layers": 0}}),
    "override_window_full": ("smollm-135m", "train_4k", _NVME,
                             {"overrides": {"prefetch_layers": 30}}),
    "override_remat_grad_accum": ("smollm-135m", "train_4k", _ROOMY,
                                  {"overrides": {"remat": "dots", "grad_accum": 4}}),
    "override_zero3_grad_accum": ("smollm-135m", "train_4k", _NVME,
                                  {"overrides": {"grad_accum": 2}}),
    "override_every_knob": ("smollm-135m", "train_4k", _NVME, {"overrides": {
        "read_ahead": 3, "nvme_workers": 4, "pinned_buffer_mb": 256,
        "act_tier": "device", "grad_tier": "host"}}),
    "param_quant_q8": ("smollm-135m", "train_4k", _NVME, {"overrides": {"param_quant": "q8"}}),
    "param_quant_q4_window": ("smollm-135m", "train_4k", _NVME,
                              {"overrides": {"param_quant": "q4", "prefetch_layers": 3}}),
    "param_quant_off_nvme": ("smollm-135m", "train_4k", _ROOMY,
                             {"overrides": {"param_quant": "q8"}}),
    "zero_nvme_bandwidth": ("smollm-135m", "train_4k", dict(_NVME, nvme_bw=0.0), {}),
    "string_names": ("smollm-135m", "train_4k",
                     dict(n_devices=16, device_mem=32e9, host_mem=1e12), {}),
    "serve_roomy": ("smollm-135m", (128, 16, "decode"),
                    dict(n_devices=1, device_mem=64e9, host_mem=64e9), {}),
    "serve_starved": ("smollm-135m", (128, 16, "decode"), "serve_starved", {}),
    "serve_starved_nvme": ("smollm-135m", (4096, 64, "decode"),
                           dict(n_devices=1, device_mem=1e9, host_mem=1e9,
                                nvme_capacity=1e12), {}),
    "serve_no_room_no_nvme": ("smollm-135m", (4096, 64, "decode"),
                              dict(n_devices=1, device_mem=1e9, host_mem=1e9), {}),
    "serve_overrides": ("smollm-135m", (64, 8, "decode"),
                        dict(n_devices=1, device_mem=32e9, host_mem=64e9),
                        {"overrides": {"kv_tier": "host", "kv_slots": 3, "kv_block_tokens": 32}}),
    "serve_slots_beyond_batch": ("smollm-135m", (64, 8, "decode"),
                                 dict(n_devices=1, device_mem=32e9, host_mem=64e9),
                                 {"overrides": {"kv_slots": 12}}),
    "h100_smoke_train": ("smollm-135m", (512, 8, "train"),
                         dict(n_devices=1, device_mem=85e9, host_mem=103e9,
                              nvme_capacity=1e12), {}),
    "h100_smoke_offload": ("smollm-135m", (512, 8, "train"),
                           dict(n_devices=1, device_mem=3e9, host_mem=103e9,
                                nvme_capacity=1e12), {}),
    "h100_grads_to_host": ("smollm-135m", (512, 8, "train"),
                           dict(n_devices=1, device_mem=1.2e9, host_mem=103e9,
                                nvme_capacity=1e12), {}),
    # MoE: the all-device plan chip_smoke trains, the layered epoch (expert
    # rows as schedule units, the expert_hot_mb decision and the residency
    # predictions), and the override checks that guard explicit-engine MoE
    "moe_h100_train": ("granite-moe-1b-a400m", (512, 8, "train"),
                       dict(n_devices=1, device_mem=85e9, host_mem=103e9,
                            nvme_capacity=1e12), {}),
    "moe_h100_layered": ("granite-moe-1b-a400m", (512, 8, "train"),
                         dict(n_devices=1, device_mem=3e9, host_mem=103e9,
                              nvme_capacity=1e12), {}),
    "moe_zero3_nvme": ("granite-moe-1b-a400m", "train_4k", _NVME,
                       {"overrides": {"engine": "zero3", "param_tier": "nvme"}}),
    "moe_zero3_hot_mb": ("granite-moe-1b-a400m", "train_4k", _NVME,
                         {"overrides": {"engine": "zero3", "param_tier": "nvme",
                                        "expert_hot_mb": 64}}),
    "moe_zero3_window": ("llama4-scout-17b-a16e", "train_4k", _NVME,
                         {"overrides": {"engine": "zero3", "param_tier": "nvme",
                                        "prefetch_layers": 3}}),
    "moe_serve": ("granite-moe-1b-a400m", (512, 8, "decode"),
                  dict(n_devices=1, device_mem=85e9, host_mem=103e9), {}),
    # the fixed-state families at the shapes chip_smoke serves and trains
    "ssm_h100_train": ("mamba2-370m", (512, 8, "train"),
                       dict(n_devices=1, device_mem=85e9, host_mem=103e9,
                            nvme_capacity=1e12), {}),
    "ssm_h100_serve": ("mamba2-370m", (544, 8, "decode"),
                       dict(n_devices=1, device_mem=85e9, host_mem=103e9), {}),
    "hybrid_h100_serve": ("recurrentgemma-9b", (2576, 8, "decode"),
                          dict(n_devices=1, device_mem=85e9, host_mem=103e9), {}),
    "hybrid_h100_train": ("recurrentgemma-9b", (4096, 1, "train"),
                          dict(n_devices=1, device_mem=85e9, host_mem=103e9,
                               nvme_capacity=1e12), {}),
    # the VLM and the encoder-decoder at the shapes chip_smoke serves and
    # trains (llava cut to 8 and 2 layers there; its full depth here)
    "vlm_h100_serve": ("llava-next-34b", (3088, 8, "decode"),
                       dict(n_devices=1, device_mem=85e9, host_mem=103e9), {}),
    "vlm_h100_train": ("llava-next-34b", (4096, 1, "train"),
                       dict(n_devices=1, device_mem=85e9, host_mem=103e9,
                            nvme_capacity=1e12), {}),
    "encdec_h100_serve": ("seamless-m4t-medium", (2080, 8, "decode"),
                          dict(n_devices=1, device_mem=85e9, host_mem=103e9), {}),
    "encdec_h100_train": ("seamless-m4t-medium", (2048, 8, "train"),
                          dict(n_devices=1, device_mem=85e9, host_mem=103e9,
                               nvme_capacity=1e12), {}),
}
for _arch in ("smollm-135m", "llama3.2-3b", "gemma-7b", "granite-moe-1b-a400m",
              "llama4-scout-17b-a16e", "mamba2-370m", "recurrentgemma-9b",
              "llava-next-34b", "seamless-m4t-medium"):
    for _shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for _hw_name, _hw in (("roomy", _ROOMY), ("nvme", _NVME),
                              ("one_h100", dict(n_devices=1, device_mem=85e9,
                                                host_mem=103e9, nvme_capacity=1e12))):
            SCENARIOS[f"{_arch}/{_shape}/{_hw_name}"] = (_arch, _shape, _hw, {})


def _both(name):
    arch, shape, hw, kw = SCENARIOS[name]
    if hw == "serve_starved":
        hw = _serve_starved_hw()
    if isinstance(shape, tuple):
        js, ts = JShape(name, *shape), TShape(name, *shape)
    else:
        js = ts = shape
    if name == "string_names":
        jm = tm = arch
    else:
        jm, tm = jconfigs.get(arch), tconfigs.get(arch)
    want = jplan.plan_run(jm, js, jplan.HardwareSpec(**hw), **kw)
    got = tplan.plan_run(tm, ts, tplan.HardwareSpec(**hw), **kw)
    return got, want


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_plan_json_explain_and_warnings_equal_reference(name):
    got, want = _both(name)
    assert got.to_json() == want.to_json()
    assert got.explain() == want.explain()
    assert got.warnings == want.warnings and got.feasible == want.feasible
    assert tplan.InfinityPlan.from_json(got.to_json()) == got
    assert tplan.InfinityPlan.from_json(want.to_json()) == got  # reads the reference's JSON


@pytest.mark.parametrize("name", ["roomy", "hbm_starved", "hbm_and_dram_starved",
                                  "override_remat_grad_accum", "param_quant_q4_window",
                                  "h100_smoke_offload"])
def test_lowered_run_config_equals_reference(name):
    got, want = _both(name)
    assert dataclasses.asdict(got.to_run_config(nvme_dir="nv")) == \
        dataclasses.asdict(want.to_run_config(nvme_dir="nv"))


@pytest.mark.parametrize("arch", ["smollm-135m", "llama3.2-3b", "gemma-7b",
                                  "nemotron-4-340b", "granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e", "mamba2-370m",
                                  "recurrentgemma-9b", "llava-next-34b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("n_devices", [1, 16])
def test_state_bytes_fields_equal_reference(arch, shape, n_devices):
    got = tplan.state_bytes(tconfigs.get(arch), tplan._resolve_shape(shape), n_devices)
    want = jplan.state_bytes(jconfigs.get(arch), jplan._resolve_shape(shape), n_devices)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _bad_override_errors(arch, shape, overrides, match):
    errs = []
    for mod, cfgs, shp in ((tplan, tconfigs, TShape), (jplan, jconfigs, JShape)):
        with pytest.raises(ValueError, match=match) as e:
            mod.plan_run(cfgs.get(arch), shp("s", *shape),
                         mod.HardwareSpec(**_NVME), overrides=overrides)
        errs.append(str(e.value))
    return errs


@pytest.mark.parametrize("overrides,match", [
    ({"nope": 1}, "unknown plan override"), ({"param_quant": "q2"}, "param_quant"),
    ({"kv_tier": "floppy"}, "kv_tier")])
def test_bad_overrides_raise_as_the_reference(overrides, match):
    shape = (64, 8, "decode") if "kv_tier" in overrides else (4096, 256, "train")
    errs = _bad_override_errors("smollm-135m", shape, overrides, match)
    assert errs[0] == errs[1]


@pytest.mark.parametrize("arch,param", [("granite-moe-1b-a400m", "device"),
                                        ("llama4-scout-17b-a16e", "host")])
def test_moe_zero3_override_without_nvme_params_raises_as_the_reference(arch, param):
    """Explicit-engine MoE exists only as the layered epoch: a plan override
    to zero3 with params off NVMe raises the reference's words."""
    errs = _bad_override_errors(arch, (4096, 256, "train"),
                                {"engine": "zero3", "param_tier": param},
                                "param_tier='nvme'")
    assert errs[0] == errs[1]


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_zero3_override_on_a_fixed_state_family_raises_as_the_reference(arch):
    """The explicit engine is dense/moe only: a plan override to zero3 on
    mamba2, recurrentgemma, llava or seamless raises the reference's
    words."""
    errs = _bad_override_errors(arch, (4096, 256, "train"), {"engine": "zero3"},
                                "dense/moe only")
    assert errs[0] == errs[1]


def test_save_load_and_summary(tmp_path):
    p = tplan.plan_run(tconfigs.get("smollm-135m"), "train_4k", tplan.HardwareSpec(**_NVME))
    path = str(tmp_path / "sub" / "plan.json")
    p.save(path)
    assert tplan.InfinityPlan.load(path) == p
    assert json.loads(p.to_json())["plan_version"] == 1
    assert p.summary().startswith("plan[smollm-135m/train_4k] engine=zero3")


# ---------------------------------------------------------------------------
# HardwareSpec.detect and the CLI plumbing
# ---------------------------------------------------------------------------


def test_detect_on_the_cpu_matches_the_reference_cpu_backend(tmp_path):
    got = tplan.HardwareSpec.detect(nvme_dir=str(tmp_path), device="cpu")
    want = jplan.HardwareSpec.detect(nvme_dir=str(tmp_path))
    assert got.n_devices == want.n_devices == 1 and got.source == "detected"
    assert got.device_mem == want.device_mem == got.host_mem == want.host_mem
    assert got.nvme_capacity > 0
    for f in ("device_bw", "host_bw", "nvme_bw", "interconnect_bw", "peak_flops",
              "devices_per_node", "working_mem_fraction"):
        assert getattr(got, f) == getattr(want, f), f
    over = tplan.HardwareSpec.detect(nvme_dir=str(tmp_path), device="cpu",
                                     device_mem=3e9, n_devices=2)
    assert (over.device_mem, over.n_devices) == (3e9, 2)


def test_detect_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplan.HardwareSpec.detect()


def test_cli_plumbing_equals_reference(tmp_path):
    import argparse

    argv = ["--plan", "auto", "--objective", "min_device_mem", "--hw-device-mem", "2e9",
            "--hw-devices", "1", "--engine", "zero3", "--prefetch-layers", "3",
            "--remat", "none", "--hw-nvme-bw", "2e9"]
    out = []
    for mod in (tplan, jplan):
        ap = argparse.ArgumentParser()
        mod.add_plan_args(ap)
        for flag, kw in (("--engine", {}), ("--prefetch-layers", {"type": int}),
                         ("--remat", {}), ("--device", {"default": "cpu"})):
            ap.add_argument(flag, **kw)
        args = ap.parse_args(argv)
        out.append((args, mod.overrides_from_argv(args, argv)))
    (targs, tover), (jargs, jover) = out
    assert tover == jover == {"engine": "zero3", "prefetch_layers": 3, "remat": "none"}
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        {k: v for k, v in vars(jargs).items() if k != "device"}
    hw = tplan.hardware_from_args(targs, nvme_dir=str(tmp_path))
    assert (hw.device_mem, hw.n_devices, hw.nvme_bw) == (2e9, 1, 2e9)
    cfg = tconfigs.smoke("smollm-135m")
    got = tplan.resolve_plan(targs, cfg, TShape("s", 32, 4, "train"), argv=argv,
                             quiet=True, hardware=hw)
    want = jplan.resolve_plan(jargs, jconfigs.smoke("smollm-135m"),
                              JShape("s", 32, 4, "train"), argv=argv, quiet=True,
                              hardware=jplan.HardwareSpec(**dataclasses.asdict(hw)))
    assert got.to_json() == want.to_json()


# ---------------------------------------------------------------------------
# the launchers under --plan auto, on the CPU
# ---------------------------------------------------------------------------

TRAIN = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", "--lr", "3e-3",
         "--log-every", "100"]


def test_train_plan_auto_runs_the_all_device_plan_with_falling_loss(tmp_path, capsys):
    hist = ttrain.main(TRAIN + ["--plan", "auto", "--steps", "6", "--nvme-dir", str(tmp_path)])
    plan, run = hist["plan"], hist["run"]
    assert plan.engine == "pjit" and set(plan.tiers.values()) == {"device"}
    assert run.parallel.engine == "pjit" and run.parallel.remat == plan.remat
    losses = hist["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    out = capsys.readouterr().out
    assert out.startswith(plan.summary()) and "predicted:" in out


def test_train_plan_auto_moves_the_optimizer_off_a_starved_device(tmp_path):
    """``--hw-device-mem`` below the states: the plan puts the optimizer on
    NVMe off-graph and keeps the params on the device; every step moves the
    predicted optimizer bytes, reported beside the measured ones."""
    hist = ttrain.main(TRAIN + ["--plan", "auto", "--steps", "6", "--hw-device-mem", "1.5e6",
                                "--nvme-dir", str(tmp_path)])
    plan, run = hist["plan"], hist["run"]
    assert (plan.param_tier, plan.grad_tier, plan.opt_tier) == ("device", "device", "nvme")
    assert run.opt_offgraph
    for m in hist["metrics"]:
        assert m["opt_read_bytes"] > 0 and m["opt_write_bytes"] > 0
        assert m["plan_opt_step_bytes"] == m["opt_read_bytes"] + m["opt_write_bytes"]
    assert hist["losses"][-1] < hist["losses"][0]


def test_train_plan_auto_legacy_flags_become_overrides(tmp_path, capsys):
    hist = ttrain.main(TRAIN + ["--plan", "auto", "--steps", "2", "--grad-accum", "2",
                                "--remat", "full", "--offload-opt", "host",
                                "--nvme-dir", str(tmp_path)])
    plan = hist["plan"]
    assert (plan.grad_accum, plan.remat, plan.opt_tier) == (2, "full", "host")
    assert "override grad_accum=2" in capsys.readouterr().out


def test_train_saved_plan_loads_and_a_mismatched_arch_raises(tmp_path):
    p = tplan.plan_run(tconfigs.smoke("smollm-135m"), TShape("cli", 32, 4, "train"),
                       tplan.HardwareSpec(n_devices=1, device_mem=1e9, host_mem=8e9))
    path = str(tmp_path / "plan.json")
    p.save(path)
    hist = ttrain.main(TRAIN + ["--plan", path, "--steps", "2", "--nvme-dir", str(tmp_path)])
    assert hist["plan"] == p
    with pytest.raises(ValueError, match="saved plan is for arch"):
        ttrain.main(TRAIN + ["--arch", "llama3.2-3b", "--plan", path, "--steps", "1"])


def test_train_manual_mode_accepts_and_ignores_the_planner_flags(tmp_path):
    """``--objective`` and ``--hw-*`` in manual mode are accepted and do not
    touch the placement, as in the reference."""
    hist = ttrain.main(TRAIN + ["--steps", "2", "--objective", "min_device_mem",
                                "--hw-nvme-bw", "2e9", "--hw-device-mem", "1e3",
                                "--nvme-dir", str(tmp_path)])
    assert hist["plan"] is None and not hist["run"].opt_offgraph
    assert hist["run"].parallel.engine == "pjit"
    assert np.isfinite(hist["losses"]).all()


SERVE = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "5",
         "--prompt-len", "16", "--new-tokens", "6", "--plan", "auto"]


def test_serve_plan_auto_keeps_every_sequence_resident_when_it_fits(capsys):
    tserve.main(SERVE)
    out = capsys.readouterr().out
    assert "SERVE SMOKE OK" in out and "KV residency within plan" in out


def test_serve_plan_auto_pages_kv_to_the_host_on_a_starved_device():
    """A device with room for the params and one sequence's KV: the plan
    takes one slot and parks the rest on the host tier; every sequence
    finishes and the device KV stays within the plan's prediction."""
    argv = SERVE + ["--hw-device-mem", "4.3e5"]
    out = tserve.run_serve(tserve._parse(argv), argv)
    plan = out["plan"]
    assert (plan.kv_tier, plan.kv_slots) == ("host", 1) == (out["kv_tier"], out["slots"])
    assert out["block_tokens"] == plan.kv_block_tokens
    assert all(out["done"]) and out["admissions"] == 4
    assert out["kv"]["resident_bytes"] <= plan.predictions["kv_resident_bytes"]
