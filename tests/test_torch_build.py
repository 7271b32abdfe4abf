"""The port's kernel build rule (``repro_torch.kernels._build``): a library
is rebuilt when it is missing or older than its own source or any shared
header in ``csrc/`` (``hopper.cuh`` is included by two sources)."""
import os

from repro_torch.kernels import _build


def test_stale_when_the_source_or_any_header_is_newer(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    src, hdr, lib = csrc / "k.cu", csrc / "h.cuh", build / "libk.so"
    for f in (src, hdr, lib):
        f.write_text("")
    os.utime(src, (100, 100))
    os.utime(hdr, (100, 100))
    os.utime(lib, (200, 200))
    assert not _build._stale("k")
    os.utime(hdr, (300, 300))
    assert _build._stale("k")
    os.utime(hdr, (100, 100))
    os.utime(src, (300, 300))
    assert _build._stale("k")
    os.utime(src, (100, 100))
    lib.unlink()
    assert _build._stale("k")


def test_hopper_header_is_shared_by_the_tma_kernels():
    """``hopper.cuh`` is the one shared header, and both TMA + wgmma
    sources include it, so editing it rebuilds both libraries."""
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == ["hopper.cuh"]
    for name in ("fused_ce", "swa_attention"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in text
