"""Auto host/device dispatch (utils/dispatch.py) + per-sequence mode-1
palindrome fallback (ops/sketch1.py)."""
import logging
import os
import sys

import numpy as np
import pytest

from pgrtk.core.spec import ShmmrSpec
from pgrtk.utils import dispatch


def test_use_device_forced_modes(monkeypatch):
    monkeypatch.setattr(dispatch, "_accel", True)
    assert dispatch.use_device(10, forced="device")
    assert not dispatch.use_device(10**9, forced="native")
    assert not dispatch.use_device(10**9, forced="python")


def test_use_device_threshold_and_accelerator(monkeypatch):
    monkeypatch.delenv("PGRTK_DEVICE_MIN_BASES", raising=False)
    monkeypatch.setattr(dispatch, "_accel", True)
    assert dispatch.use_device(dispatch.DEFAULT_MIN_BASES)
    assert not dispatch.use_device(dispatch.DEFAULT_MIN_BASES - 1)
    monkeypatch.setattr(dispatch, "_accel", False)
    assert not dispatch.use_device(10**9)


def test_use_device_env_threshold(monkeypatch):
    monkeypatch.setattr(dispatch, "_accel", True)
    monkeypatch.setenv("PGRTK_DEVICE_MIN_BASES", "100")
    assert dispatch.use_device(100)
    assert not dispatch.use_device(99)


def test_tests_run_on_cpu_backend_no_auto_device():
    # conftest forces JAX_PLATFORMS=cpu: the real accelerator probe must
    # say "no accelerator" here, keeping tests on the host path
    dispatch._accel = None
    assert not dispatch.accelerator_present()


def test_mode1_palindrome_fallback_is_per_sequence():
    """One palindromic k-mer must only send ITS sequence to the scalar
    path; the rest of the batch stays device-computed — and every result
    stays exact (ops/sketch1.py)."""
    from pgrtk.native import api as native
    from pgrtk.ops import sketch1

    spec = ShmmrSpec(w=24, k=16, r=1, min_span=0, sketch=False)
    rng = np.random.RandomState(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [bytes(rng.choice(bases, 3000).tolist()) for _ in range(4)]
    # splice a k-palindrome (s + revcomp(s), k=16) into sequence 2
    half = b"ACGTTGCACCGGATAC"[: spec.k // 2]
    comp = bytes(reversed(half.translate(bytes.maketrans(b"ACGT", b"TGCA"))))
    palin = half + comp
    s2 = bytearray(seqs[2])
    s2[1500 : 1500 + spec.k] = palin
    seqs[2] = bytes(s2)

    dense = sketch1.sketch_mode1_dense(
        *_pad(seqs), spec.k, spec.w, 512
    )
    flags = np.asarray(dense["palindrome_seen"])
    assert flags.shape == (4,)
    assert flags[2] and not flags[0] and not flags[1] and not flags[3]

    got = sketch1.sketch_mode1(seqs, spec=spec)
    want = native.batch_sequence_to_shmmrs(
        [(i, s) for i, s in enumerate(seqs)], spec
    )
    assert got == want


def _pad(seqs, chunk=512):
    import jax.numpy as jnp

    from pgrtk.ops import sketch as sketch_ops

    arr, lens = sketch_ops.pad_batch(seqs, multiple=chunk)
    return jnp.asarray(arr), jnp.asarray(lens)


@pytest.fixture
def gpu_nodes(monkeypatch):
    """An H100 host as the probe sees it: NVIDIA device nodes present,
    no JAX_PLATFORMS request."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(
        dispatch, "_gpu_device_nodes", lambda: ["/dev/nvidiactl", "/dev/nvidia0"]
    )


@pytest.mark.parametrize("platform, present", [("gpu", True), ("cpu", False)])
def test_detect_accelerator_reads_nvidia_nodes(
    gpu_nodes, monkeypatch, caplog, platform, present
):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with caplog.at_level(logging.ERROR, logger="pgrtk"):
        assert dispatch._detect_accelerator() is present
    # nodes but a CPU backend: said loudly, naming the platform JAX started
    assert ("'cpu' platform" in caplog.text) is (not present)


def test_detect_accelerator_backend_failure_logs_error(
    gpu_nodes, monkeypatch, caplog
):
    import jax

    def fail():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "default_backend", fail)
    with caplog.at_level(logging.ERROR, logger="pgrtk"):
        assert dispatch._detect_accelerator() is False
    assert "Unable to initialize backend 'cuda'" in caplog.text


def test_detect_accelerator_without_nodes_skips_jax(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(dispatch, "_gpu_device_nodes", lambda: [])
    monkeypatch.delitem(sys.modules, "jax")
    assert dispatch._detect_accelerator() is False
    assert "jax" not in sys.modules


def test_device_decision_names_platform(monkeypatch, caplog):
    monkeypatch.setattr(dispatch, "_logged", set())
    with caplog.at_level(logging.INFO, logger="pgrtk"):
        assert dispatch.use_device(10, forced="device", what="t")
    assert "dispatch t: device [cpu cpu] backend" in caplog.text


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compile_cache_dir(monkeypatch, env_dir):
    import jax

    from pgrtk import ops

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert ops.enable_compile_cache() == os.path.join(repo, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert ops.enable_compile_cache() == env_dir
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == (
        env_dir or ops.DEFAULT_COMPILE_CACHE_DIR
    )
    if env_dir is None:
        assert jax.config.jax_compilation_cache_dir == ops.DEFAULT_COMPILE_CACHE_DIR
