"""Version shim layer (counterpart of the JAX package's
``shims/loader.py``).

The reference supports several Spark releases from ONE plugin jar by
ServiceLoader-discovering a version-matched provider of the
version-sensitive APIs (sql-plugin/.../SparkShims.scala:38-71 trait;
ShimLoader.scala:26-60 provider matching). The JAX package's version
axis is the jax release train; the port's is PyTorch and CUDA: the NVTX
ranges, the device memory query, pinned host memory and the nvcc
architecture flag are the calls that move between releases. Same
design:

- ``TpuShims``: the trait; every version-sensitive call the rest of the
  port makes goes through it (``obs/trace.py``, ``memory/device.py``,
  ``memory/discovery.py``, ``nativelib.py``, ``ops/cudalib.py``).
- ``ShimServiceProvider`` subclasses: one per supported release range,
  each declaring ``matches(version)`` on the running torch version and
  building its shims. One provider covers every torch release the port
  supports (2.x), where these spellings do not differ.
- ``ShimLoader.get_shims()``: picks the first provider matching the
  running torch, caches it; ``SPARK_RAPIDS_TPU_SHIM`` forces one by name.

The JAX package's mesh and sharding calls (``make_mesh``,
``named_sharding``, ``replicated_sharding``) wait for the mesh half of
the shuffle (ROADMAP, A.9): they raise here. Its ``jit``, ``device_put``
and tree utilities have no counterpart in eager PyTorch.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch

# the nvcc target of every kernel in csrc/: Hopper with its
# architecture-specific features (sm_90a). The compile cache and the
# pre-warm manifest key on the flag string, so it is kept byte for byte.
SM90A_GENCODE = "-gencode=arch=compute_90a,code=sm_90a"


class TpuShims:
    """Version-sensitive API surface (the SparkShims trait analogue)."""

    version_name: str = "base"

    # --- profiling ranges ----------------------------------------------------
    def nvtx_push(self, name: str) -> None:
        raise NotImplementedError

    def nvtx_pop(self) -> None:
        raise NotImplementedError

    # --- device memory -------------------------------------------------------
    def mem_get_info(self, device) -> Tuple[int, int]:
        """(free, total) bytes of a CUDA device."""
        raise NotImplementedError

    def device_count(self) -> int:
        raise NotImplementedError

    # --- host memory ---------------------------------------------------------
    def empty_host(self, nbytes: int, pinned: bool) -> torch.Tensor:
        """A uint8 host buffer of ``nbytes``, page-locked if ``pinned``."""
        raise NotImplementedError

    # --- kernel builds -------------------------------------------------------
    def nvcc_arch_flags(self) -> Tuple[str, ...]:
        """The nvcc flags that pick the kernels' target architecture."""
        raise NotImplementedError

    # --- meshes & shardings (A.9) --------------------------------------------
    def make_mesh(self, axis_shapes: Sequence[int],
                  axis_names: Sequence[str], devices=None):
        raise NotImplementedError(
            "device meshes come with the mesh half of the shuffle "
            "(ROADMAP, A.9)")

    def named_sharding(self, mesh, *spec):
        raise NotImplementedError(
            "shardings come with the mesh half of the shuffle (ROADMAP, A.9)")

    def replicated_sharding(self, mesh):
        raise NotImplementedError(
            "shardings come with the mesh half of the shuffle (ROADMAP, A.9)")

    # --- introspection -------------------------------------------------------
    def devices(self) -> List:
        raise NotImplementedError

    def default_backend(self) -> str:
        raise NotImplementedError


class _Torch2Shims(TpuShims):
    """torch 2.x with CUDA 12: ``torch.cuda.nvtx``,
    ``torch.cuda.mem_get_info`` and ``pin_memory=`` on ``torch.empty``."""

    version_name = "torch2"

    def nvtx_push(self, name: str) -> None:
        torch.cuda.nvtx.range_push(name)

    def nvtx_pop(self) -> None:
        torch.cuda.nvtx.range_pop()

    def mem_get_info(self, device) -> Tuple[int, int]:
        free, total = torch.cuda.mem_get_info(device)
        return int(free), int(total)

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def empty_host(self, nbytes: int, pinned: bool) -> torch.Tensor:
        return torch.empty(int(nbytes), dtype=torch.uint8, pin_memory=pinned)

    def nvcc_arch_flags(self) -> Tuple[str, ...]:
        return (SM90A_GENCODE,)

    def devices(self) -> List:
        return [torch.device("cuda", i) for i in range(self.device_count())]

    def default_backend(self) -> str:
        return "gpu" if torch.cuda.is_available() else "cpu"


class ShimServiceProvider:
    """One per supported release range (SparkShimServiceProvider)."""

    name: str = "?"

    def matches(self, version: Tuple[int, ...]) -> bool:
        raise NotImplementedError

    def build(self) -> TpuShims:
        raise NotImplementedError


class Torch2Provider(ShimServiceProvider):
    name = "torch2"

    def matches(self, version):
        return (2, 0) <= version < (3,)

    def build(self):
        return _Torch2Shims()


class ShimLoader:
    """Pick the provider matching the running torch (ShimLoader.scala:
    26-60: iterate registered providers, first match wins)."""

    _PROVIDERS: List[ShimServiceProvider] = [Torch2Provider()]
    _cached: Optional[TpuShims] = None

    @staticmethod
    def parse_version(text: str) -> Tuple[int, ...]:
        """'2.13.0+cpu' -> (2, 13, 0): the leading digits of up to three
        dot-separated parts (a local suffix or a dev tag is dropped)."""
        parts = []
        for p in text.split("+")[0].split(".")[:3]:
            digits = ""
            for ch in p:
                if not ch.isdigit():
                    break
                digits += ch
            parts.append(int(digits) if digits else 0)
        return tuple(parts)

    @classmethod
    def register(cls, provider: ShimServiceProvider) -> None:
        cls._PROVIDERS.insert(0, provider)
        cls._cached = None

    @classmethod
    def get_shims(cls) -> TpuShims:
        if cls._cached is not None:
            return cls._cached
        override = os.environ.get("SPARK_RAPIDS_TPU_SHIM")
        if override:
            for p in cls._PROVIDERS:
                if p.name == override:
                    cls._cached = p.build()
                    return cls._cached
            raise RuntimeError(f"no shim provider named {override!r} "
                               f"(have {[p.name for p in cls._PROVIDERS]})")
        version = cls.parse_version(torch.__version__)
        for p in cls._PROVIDERS:
            if p.matches(version):
                cls._cached = p.build()
                return cls._cached
        raise RuntimeError(
            f"no shim provider matches torch {torch.__version__} (CUDA "
            f"{torch.version.cuda}); supported: "
            f"{[p.name for p in cls._PROVIDERS]}")


def shims() -> TpuShims:
    """The running release's shims (``ShimLoader.get_shims``)."""
    return ShimLoader.get_shims()
