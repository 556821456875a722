"""The kernel build module's reading of the compiler's report: registers and
spill bytes of every kernel, from the ``-Xptxas -v`` lines that the build
keeps beside each library (``chip_smoke.py`` prints them).  No compiler
runs here: the report is a fixed text in the format ptxas writes."""
from repro_torch.kernels import _build

LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z8kernel_aILi4EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_aILi4EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 117 registers, used 1 barriers, 1024 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8kernel_bv' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_bv
    8 bytes stack frame, 28 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = _build.sources()[0]
    _build._target(src).with_suffix(".log").write_text(LOG)
    assert _build.ptxas_report() == [
        {"source": src.name, "kernel": "_Z8kernel_aILi4EEvv", "registers": 117,
         "spill_stores": 0, "spill_loads": 0},
        {"source": src.name, "kernel": "_Z8kernel_bv", "registers": 255,
         "spill_stores": 28, "spill_loads": 52}]


SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : _Z8kernel_aILi4EEvv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   HGMMA.64x256x16.F32.BF16 R24, R152, gdesc[UR4], R24 ;  /* 0x0000000498187df0 */
        /*0020*/              @!P0 HGMMA.64x256x16.F32.BF16 R24, R156, gdesc[UR8], R24, gsb0 ;
        /*0030*/               @UPT HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0040*/                   EXIT ;
\t\t..........

\t\tFunction : _Z8kernel_bv
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/              @P1  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        /*0020*/                   BRA 0x20 ;
"""


def _sass_plain(text, opcodes):
    # a transcription: a function starts at "Function :"; an instruction is
    # the first upper-case word after its /*address*/ and an optional guard
    out, fn = {}, None
    for line in text.splitlines():
        words = line.split()
        if "Function" in words and ":" in words:
            fn = words[words.index(":") + 1]
            out[fn] = {op: 0 for op in opcodes}
        elif fn and words and words[0].startswith("/*") and words[0].endswith("*/") \
                and not words[0].startswith("/* "):
            rest = words[1:]
            if rest and rest[0].startswith("@"):
                rest = rest[1:]
            stem = rest[0].split(".")[0] if rest else ""
            if stem in out[fn]:
                out[fn][stem] += 1
    return out


def test_parse_sass_counts_opcodes_per_function():
    ops = ("HGMMA", "HMMA", "EXIT")
    got = _build.parse_sass(SASS, ops)
    assert got == _sass_plain(SASS, ops)
    assert got == {"_Z8kernel_aILi4EEvv": {"HGMMA": 2, "HMMA": 1, "EXIT": 1},
                   "_Z8kernel_bv": {"HGMMA": 0, "HMMA": 2, "EXIT": 0}}
