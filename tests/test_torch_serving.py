"""The port's serving path on the CPU: tier stores and paged KV with bf16
leaves, NVMe files shared with the JAX package, the continuous-batching
driver (paged host tier against all-device, token for token, as
``tests/test_serving.py`` asks of the reference), the entry points' device
and not-yet-ported options, and the import boundary (the port and
``chip_smoke.py`` load no JAX and nothing of the JAX package)."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import kvcache  # noqa: E402
from repro_torch.core.offload import HostArrayStore, NvmeStore, PinnedBufferPool  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _toy_cache(rng, L=3, S=20, KV=2, D=4):
    """Dense-layout KV dict: two bf16 5-dim seq leaves, one opaque leaf."""
    def f(*shp, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shp).astype(np.float32)).to(dtype)
    return {"k": f(L, 1, S, KV, D), "v": f(L, 1, S, KV, D),
            "aux": f(L, 1, 7, dtype=torch.float32)}


@pytest.mark.parametrize("tier", ["host", "nvme"])
@pytest.mark.parametrize("length,block,cap", [(20, 8, 32), (7, 16, 7), (16, 4, 16)])
def test_paged_kv_roundtrip_bf16(tmp_path, tier, length, block, cap):
    """Only live tokens park, in ceil(len/block) blocks; the fetch comes back
    bit-identical and zero-padded to capacity; drop reclaims the tier."""
    rng = np.random.default_rng(length * 31 + block)
    cache = _toy_cache(rng, S=length)
    store = (NvmeStore(str(tmp_path), pool_mb=4) if tier == "nvme"
             else HostArrayStore(pool_mb=4))
    kv = kvcache.PagedKVCache(store, block_tokens=block)
    nbytes = kv.park("s0", cache, length)
    assert nbytes == sum(t.numel() * t.element_size() for t in cache.values())
    kv.flush()
    got, glen = kv.fetch("s0", cap)
    assert glen == length
    for name in ("k", "v"):
        g = got[name]
        assert g.dtype == torch.bfloat16 and g.shape[2] == cap
        assert torch.equal(g[:, :, :length], cache[name])
        assert not g[:, :, length:].any()
    assert torch.equal(got["aux"], cache["aux"])
    assert len([k for k in store.keys() if "/k/" in k]) == kv.n_blocks(length)
    kv.drop("s0")
    assert kv.parked_bytes() == 0 and not store.keys()
    if tier == "nvme":
        assert not os.listdir(tmp_path)
    store.close()


def test_fetch_handle_is_windowed_and_idempotent():
    rng = np.random.default_rng(7)
    kv = kvcache.PagedKVCache(HostArrayStore(pool_mb=4), block_tokens=4,
                              prefetch_blocks=2)
    kv.park("s0", _toy_cache(rng, S=20), 20)
    h = kv.start_fetch("s0", 32)
    assert len(h._inflight) <= kv.prefetch_blocks
    h.poll()
    got, glen = h.result()
    again, glen2 = h.result()
    assert again is got and glen == glen2 == 20 and h.done()


def test_nvme_files_shared_with_jax_package(tmp_path):
    """Same hashed names, ``.meta`` sidecars and dtype names: a directory
    written by either package reopens in the other, bf16 bits intact."""
    import ml_dtypes

    from repro.core.offload import NvmeStore as JaxNvmeStore

    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    js = JaxNvmeStore(str(tmp_path), pool_mb=4)
    js.write("layer/0", a)
    js.flush()
    ts = NvmeStore(str(tmp_path), pool_mb=4)  # reopen from the sidecars
    got = ts.read("layer/0").result()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 5)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), a.view(np.int16))

    b = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).to(torch.bfloat16)
    ts.write("layer/1", b)
    ts.flush()
    back = JaxNvmeStore(str(tmp_path), pool_mb=4).read("layer/1").result()
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.int16), b.view(torch.int16).numpy())
    for s in (js, ts):
        s.close()


@pytest.mark.parametrize("overlap", [True, False])
def test_store_counters_roundtrip_and_pool_budget(overlap):
    pool = PinnedBufferPool(1 << 16)
    store = HostArrayStore(pool=pool, overlap=overlap)
    m = store.mark()
    t = torch.arange(1000, dtype=torch.int32)
    store.write("a", t)
    store.flush()
    assert torch.equal(store.read("a").result(), t)
    d = store.delta_since(m)
    assert d["bytes_written"] == d["bytes_read"] == 4000
    back = store.roundtrip("b", t.to(torch.bfloat16)).result()
    assert back.dtype == torch.bfloat16 and torch.equal(back, t.to(torch.bfloat16))
    assert sorted(store.keys()) == ["a", "b"]
    assert 0 < pool.peak_resident <= pool.budget
    store.close()


def _serve(argv):
    return serve.run_serve(serve._parse(argv), argv)


def test_paged_host_decode_matches_all_device(tmp_path):
    """More sequences than device slots, KV waiting on the host tier:
    per-sequence tokens are identical to an all-device run."""
    base = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "5",
            "--prompt-len", "16", "--new-tokens", "6"]
    paged = _serve(base + ["--kv-tier", "host", "--kv-slots", "2"])
    full = _serve(base + ["--kv-slots", "5"])
    assert paged["generated"] == full["generated"]
    assert all(paged["done"]) and all(full["done"])
    assert paged["admissions"] == 3  # seqs 2-4 really streamed through host
    assert paged["kv"]["in_bytes"] > 0 and paged["kv"]["out_bytes"] > 0
    assert full["admissions"] == 0 and full["kv"]["in_bytes"] == 0
    assert all(len(g) == 6 for g in paged["generated"])
    nvme = _serve(base + ["--kv-tier", "nvme", "--kv-slots", "1",
                          "--kv-dir", str(tmp_path)])
    assert nvme["generated"] == full["generated"] and nvme["admissions"] == 4


def test_eos_finishes_a_slot_early():
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "4",
            "--prompt-len", "16", "--new-tokens", "6", "--kv-tier", "host",
            "--kv-slots", "2"]
    base = _serve(argv)
    t = base["generated"][1][2]
    got = _serve(argv + ["--eos-id", str(t)])
    assert got["generated"] == [g[: g.index(t) + 1] if t in g else g
                                for g in base["generated"]]
    assert all(got["done"])


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _serve(["--smoke", "--batch", "1"])


@pytest.mark.parametrize("flag", [["--plan", "auto", "--hw-devices", "2"],
                                  ["--model-mesh", "2"]])
def test_unported_options_raise_with_roadmap_pointer(flag):
    """A model axis the smoke smollm's heads do not split over serves
    under context parallelism (``tests/test_torch_cp_serve.py``) and a
    plan for 2 devices on 2 ranks (``tests/test_torch_serve_mesh.py``):
    in a run of one process each raises naming the torchrun launch of
    ``launch.serve`` that gives it them."""
    error, match = (ValueError, r"torchrun --standalone --nproc-per-node 2 -m "
                                r"repro_torch\.launch\.serve")
    with pytest.raises(error, match=match):
        _serve(["--smoke", "--device", "cpu", "--batch", "1"] + flag)


@pytest.mark.parametrize("fmt,share", [("q8", 0.6), ("q4", 0.35)])
def test_kv_quant_parks_wire_bytes_on_the_host_tier(fmt, share):
    """``--kv-quant``: waiting sequences park as q8/q4 frames (decoded on
    the host when admitted); every sequence finishes, and the tier moves
    the format's share of the logical KV bytes (plus a header per block)."""
    out = _serve(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "5",
                  "--prompt-len", "64", "--new-tokens", "6", "--kv-tier", "host",
                  "--kv-slots", "2", "--kv-block-tokens", "64", "--kv-quant", fmt])
    assert all(out["done"]) and out["admissions"] == 3
    assert all(len(g) == 6 for g in out["generated"])
    kv = out["kv"]
    assert kv["in_bytes"] > 0 and kv["out_bytes"] == kv["in_bytes"]
    assert 0 < kv["out_wire_bytes"] <= share * kv["out_bytes"]
    assert 0 < kv["in_wire_bytes"] <= share * kv["in_bytes"]


def test_profile_counts_device_time_once(capsys):
    """profile_serve takes device time from device-side events only (an
    aten row's device time repeats its kernels') and the busy share from
    their union, so overlapping events count once."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    from repro_torch.launch import profile_serve

    def ev(name, dev, start, end):
        return NS(name=name, device_type=dev, time_range=Interval(start, end))

    evs = [ev("aten::mm", DeviceType.CPU, 0, 50), ev("gemm", DeviceType.CUDA, 10, 40),
           ev("copy", DeviceType.CUDA, 30, 60), ev("gemm", DeviceType.CUDA, 100, 110)]
    prof = NS(events=lambda: evs, key_averages=lambda: [])
    profile_serve._report("t", prof, wall_s=200e-6, calls=1, top=5)
    out = capsys.readouterr().out
    # device 30 + 30 + 10 us; busy [10, 60] and [100, 110] = 60 us of 200
    assert "device 0.070 ms/call over 3.0 device events/call" in out
    assert "device busy 0.300 of wall" in out
    assert "0.0400   0.571      2.0  gemm" in out


FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax_or_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_port_and_chip_smoke_loads_no_jax():
    mods = sorted({".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                   .removesuffix(".__init__") for p in _port_files()[:-1]})
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"sys.path.insert(0, {str(ROOT)!r}); import chip_smoke\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            f"assert not bad, bad\n"
            f"print(len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """No result and a non-zero exit where there is no CUDA, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == "", (script, r.stdout, r.stderr[-500:])
