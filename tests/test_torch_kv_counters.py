"""The port's serve driver against the reference's on the CPU: the same
weights (the reference's initial parameters, handed to the port through
``bridge.params_from_numpy``), the same prompts (both drivers draw them
from ``--seed`` with numpy), five sequences through two slots on the host
tier. Every waiting sequence parks its whole cache, the ``len`` placeholder
included, so the ``kv`` byte counters and the generated tokens agree with
the reference's exactly, raw and under ``--kv-quant q8`` (whose wire frames
carry the placeholder as raw bytes). Depth is cut as the family tests cut
it: recurrentgemma at one group and its two-block tail (5 layers). The
prompt is 8 positions, 16 for llava and seamless (``PROMPT``); seamless's
waiting caches park their decoder K/V in blocks and their cross-attention
K/V whole, which is where padded and parked bytes would part."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ARGV = ["--smoke", "--batch", "5", "--kv-slots", "2", "--kv-tier", "host",
        "--new-tokens", "4"]
KV_KEYS = ("in_bytes", "out_bytes", "in_wire_bytes", "out_wire_bytes")


# llava's prompt holds its 8 vision positions and 8 tokens, seamless's
# gives 16 frames and 4 decoder tokens
PROMPT = {"llava-next-34b": 16, "seamless-m4t-medium": 16}


@pytest.mark.parametrize("arch,layers,quant", [
    ("smollm-135m", 0, "none"),
    ("granite-moe-1b-a400m", 0, "none"),
    ("mamba2-370m", 0, "none"),
    ("recurrentgemma-9b", 5, "none"),
    ("smollm-135m", 0, "q8"),
    ("llava-next-34b", 0, "none"),
    ("llava-next-34b", 0, "q8"),
    ("seamless-m4t-medium", 0, "none"),
    ("seamless-m4t-medium", 0, "q8"),
])
def test_serve_kv_counters_and_tokens_equal_the_reference(monkeypatch, arch, layers, quant):
    argv = ["--arch", arch, *ARGV, "--prompt-len", str(PROMPT.get(arch, 8)),
            "--kv-quant", quant]
    if layers:
        cut = dataclasses.replace(jconfigs.smoke(arch), n_layers=layers)
        monkeypatch.setattr(jserve.configs, "smoke", lambda name: cut)
    init = {}
    ref_init_state = jserve.ZeroInfinityEngine.init_state

    def keep_init(self, rng):
        state = ref_init_state(self, rng)
        init["params"] = jax.tree.map(np.asarray, state["params"])
        return state

    monkeypatch.setattr(jserve.ZeroInfinityEngine, "init_state", keep_init)
    want = jserve.run_serve(jserve._parse(argv), argv)
    monkeypatch.setattr(tserve.ZeroInfinityEngine, "init_params",
                        lambda self, gen: bridge.params_from_numpy(init["params"]))
    targv = argv + ["--device", "cpu"] + (["--layers", str(layers)] if layers else [])
    got = tserve.run_serve(tserve._parse(targv), [])
    assert want["admissions"] == got["admissions"] == 3
    assert got["generated"] == want["generated"]
    assert {k: got["kv"][k] for k in KV_KEYS} == {k: want["kv"][k] for k in KV_KEYS}
    assert got["kv"]["out_bytes"] > 0
