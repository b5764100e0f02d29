"""The port's version shim layer (``shims/loader.py``): the six cases of
``tests/test_shims.py`` on the torch axis (reference: ShimLoader.scala:
26-60 provider matching). The JAX package's tree, mesh, sharding and jit
calls have no counterpart yet: the mesh ones raise, pending A.9."""

import os

import pytest
import torch

from spark_rapids_tpu_torch.shims.loader import (
    SM90A_GENCODE, ShimLoader, ShimServiceProvider, Torch2Provider, TpuShims,
)


def test_parse_version():
    assert ShimLoader.parse_version("2.13.0+cpu") == (2, 13, 0)
    assert ShimLoader.parse_version("2.5.1+cu124") == (2, 5, 1)
    assert ShimLoader.parse_version("2.6.0a0+git1234") == (2, 6, 0)
    assert ShimLoader.parse_version("0.4.26.dev1") == (0, 4, 26)
    assert ShimLoader.parse_version("1.0") == (1, 0)


def test_provider_matching_ranges():
    p = Torch2Provider()
    assert p.matches((2, 0, 0)) and p.matches((2, 13, 0))
    assert not p.matches((1, 13, 1)) and not p.matches((3, 0, 0))


def test_loader_picks_running_version():
    shims = ShimLoader.get_shims()
    v = ShimLoader.parse_version(torch.__version__)
    assert Torch2Provider().matches(v)
    assert shims.version_name == "torch2"
    # cached: same instance on second call
    assert ShimLoader.get_shims() is shims


def test_shims_host_memory_and_devices():
    shims = ShimLoader.get_shims()
    buf = shims.empty_host(1 << 10, pinned=False)
    assert buf.dtype == torch.uint8 and buf.numel() == 1 << 10
    assert not buf.is_pinned()
    assert shims.device_count() == torch.cuda.device_count()
    assert shims.default_backend() in ("gpu", "cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        shims.make_mesh([4, 2], ("dp", "tp"))
    with pytest.raises(NotImplementedError, match="A.9"):
        shims.named_sharding(None, "dp")
    with pytest.raises(NotImplementedError, match="A.9"):
        shims.replicated_sharding(None)


def test_shims_nvcc_flags_stay_byte_identical():
    """The compile cache and the pre-warm manifest key on the flag
    string: routing the arch flag through the shims leaves it as it was."""
    from spark_rapids_tpu_torch.ops import cudalib
    assert ShimLoader.get_shims().nvcc_arch_flags() == (SM90A_GENCODE,)
    assert " ".join(cudalib.NVCC_FLAGS) == (
        "-gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared "
        "-Xcompiler -fPIC -Xptxas -v")


def test_custom_provider_registration_and_override(monkeypatch):
    class FakeShims(TpuShims):
        version_name = "fake"

    class FakeProvider(ShimServiceProvider):
        name = "fake"

        def matches(self, version):
            return False  # never auto-selected

        def build(self):
            return FakeShims()

    saved = list(ShimLoader._PROVIDERS)
    try:
        ShimLoader.register(FakeProvider())
        monkeypatch.setenv("SPARK_RAPIDS_TPU_SHIM", "fake")
        ShimLoader._cached = None
        assert ShimLoader.get_shims().version_name == "fake"
        monkeypatch.setenv("SPARK_RAPIDS_TPU_SHIM", "nope")
        ShimLoader._cached = None
        with pytest.raises(RuntimeError, match="no shim provider named"):
            ShimLoader.get_shims()
    finally:
        ShimLoader._PROVIDERS[:] = saved
        ShimLoader._cached = None
        monkeypatch.delenv("SPARK_RAPIDS_TPU_SHIM", raising=False)
        ShimLoader.get_shims()  # restore the real selection
    assert "SPARK_RAPIDS_TPU_SHIM" not in os.environ
