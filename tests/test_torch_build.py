"""The port's kernel build, on the CPU and without nvcc: the library's name
follows every source file under ``csrc/`` and the flags, so an edit to a
header rebuilds; and the readers of ptxas's report and of the SASS listing
that ``chip_smoke.py``'s build phase prints."""
from __future__ import annotations

import shutil
import subprocess

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the package's csrc/ and a build dir beside it; nothing
    may start a compiler."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"a process was started: {args}")
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    return copy, tmp_path / "_build"


def test_library_path_is_stable(csrc):
    src, build = csrc
    first = _build.library_path(src, build)
    assert first == _build.library_path(src, build)
    assert first.parent == build and first.suffix == ".so"
    # Files that are not sources do not count.
    (src / "NOTES.txt").write_text("not compiled")
    assert _build.library_path(src, build) == first


@pytest.mark.parametrize("edit", ["header", "source", "new_header",
                                  "renamed"])
def test_library_path_follows_every_source(csrc, edit):
    src, build = csrc
    before = _build.library_path(src, build)
    header = src / "hopper.cuh"
    if edit == "header":
        header.write_text(header.read_text() + "\n// edited\n")
    elif edit == "source":
        cu = src / "flash_attention.cu"
        cu.write_text(cu.read_text().replace("kStages = 2", "kStages = 3"))
    elif edit == "new_header":
        (src / "extra.h").write_text("#pragma once\n")
    else:
        header.rename(src / "hopper2.cuh")
    after = _build.library_path(src, build)
    assert after != before
    if edit == "header":     # and back again: the old library is reused
        header.write_text(header.read_text().replace("\n// edited\n", ""))
        assert _build.library_path(src, build) == before


def test_library_path_follows_the_flags(csrc, monkeypatch):
    src, build = csrc
    before = _build.library_path(src, build)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path(src, build) != before


def test_the_package_sources_are_hashed():
    names = {p.name for p in _build.CSRC_DIR.iterdir()
             if p.suffix in _build.SOURCE_SUFFIXES}
    assert {"flash_attention.cu", "hopper.cuh"} <= names


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a416flash_fwd_kernelI13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_PT_Pfiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a416flash_fwd_kernelI13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_PT_Pfiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a419flash_bwd_dq_kernelI6__halfLi128EEEvPKT_S4_S4_S4_PKfS6_PS2_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a419flash_bwd_dq_kernelI6__halfLi128EEEvPKT_S4_S4_S4_PKfS6_PS2_iifi
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a420flash_bwd_dkv_kernelI13__nv_bfloat16Li32EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PT_S6_iiifi
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*01f0*/                   SYNCS.EXCH.64 URZ, [UR8+0x14000], UR4 ;
        /*0300*/              @!P0 SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR5], RZ ;
        /*0400*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0410*/                   UBLKCP.S.G [UR8], [UR10], UR6 ;
        /*09b0*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT ;
        /*0a90*/                   HGMMA.64x32x16.F32.BF16 R24, R28, gdesc[UR12].tnspB, R24, gsb0 ;
\t\t..........
\t\tFunction : _ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a419flash_bwd_dq_kernelI6__halfLi16EEEvPKT_S4_S4_S4_PKfS6_PS2_iifi
        /*0100*/                   HMMA.16816.F32 R4, R8, R12, R4 ;
        /*0110*/               @P1 HMMA.16816.F32 R16, R8, R14, R16 ;
"""


def test_ptxas_usage_reads_registers_and_spills():
    usage = _build.ptxas_usage(PTXAS_LOG)
    assert usage == {
        "flash_fwd_kernel<bf16,64>": {"registers": 128, "spill_bytes": 0},
        "flash_bwd_dq_kernel<fp16,128>": {"registers": 255,
                                          "spill_bytes": 24},
    }


def test_sass_counts_group_the_hopper_opcodes():
    counts = _build.sass_counts(SASS)
    assert counts == {
        "flash_bwd_dkv_kernel<bf16,32>": {"HGMMA": 2, "TMA": 2, "HMMA": 0,
                                          "SYNCS": 2},
        "flash_bwd_dq_kernel<fp16,16>": {"HGMMA": 0, "TMA": 0, "HMMA": 2,
                                         "SYNCS": 0},
    }


@pytest.mark.parametrize("mangled,label", [
    ("_ZN3foo16flash_fwd_kernelI13__nv_bfloat16Li128EEEv", "flash_fwd_kernel<bf16,128>"),
    ("_ZN3foo20flash_bwd_dkv_kernelI6__halfLi16EEEv", "flash_bwd_dkv_kernel<fp16,16>"),
    ("_Z11other_kernelv", "_Z11other_kernelv"),
])
def test_kernel_label(mangled, label):
    assert _build.kernel_label(mangled) == label


def test_nvcc_path_prefers_cuda_home(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc_path() == str(nvcc)


def test_disassemble_runs_cuobjdump_beside_nvcc(tmp_path, monkeypatch):
    (tmp_path / "cuobjdump").write_text("")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    seen = []

    def run(argv, **kwargs):
        seen.append(argv)
        return subprocess.CompletedProcess(argv, 0, stdout=SASS, stderr="")
    monkeypatch.setattr(subprocess, "run", run)
    library = tmp_path / "lib.so"
    assert _build.disassemble(library) == SASS
    assert seen == [[str(tmp_path / "cuobjdump"), "-sass", str(library)]]


def _clean_build() -> dict[str, dict[str, int]]:
    """Counts of a good build: 3 kernels x 2 types x 4 head dims, each with
    wgmma and TMA, no mma.sync and no spill."""
    return {f"{kernel}<{dtype},{d}>": {"registers": 168, "spill_bytes": 0,
                                       "HGMMA": 16, "TMA": 4, "HMMA": 0,
                                       "SYNCS": 15}
            for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                           "flash_bwd_dkv_kernel")
            for dtype in ("bf16", "fp16") for d in (16, 32, 64, 128)}


@pytest.mark.parametrize("fault,message", [
    (None, None),
    ("dq_without_hgmma", "flash_bwd_dq_kernel<bf16,64> has no wgmma"),
    ("dq_without_tma", "flash_bwd_dq_kernel<fp16,16> has no wgmma or no TMA"),
    ("hmma", "flash_bwd_dq_kernel<bf16,64> has 96 mma.sync"),
    ("spill", "flash_fwd_kernel<fp16,128> spills 24 bytes"),
    ("missing", "23 kernel instances, not 24"),
])
def test_build_problems_catch_each_fault(fault, message):
    import chip_smoke
    kernels = _clean_build()
    if fault == "dq_without_hgmma":
        kernels["flash_bwd_dq_kernel<bf16,64>"]["HGMMA"] = 0
    elif fault == "dq_without_tma":
        kernels["flash_bwd_dq_kernel<fp16,16>"]["TMA"] = 0
    elif fault == "hmma":
        kernels["flash_bwd_dq_kernel<bf16,64>"]["HMMA"] = 96
    elif fault == "spill":
        kernels["flash_fwd_kernel<fp16,128>"]["spill_bytes"] = 24
    elif fault == "missing":
        del kernels["flash_bwd_dkv_kernel<bf16,32>"]
    problems = chip_smoke.build_problems(kernels)
    if fault is None:
        assert problems == []
    else:
        assert len(problems) == 1 and problems[0].startswith(message), \
            problems
