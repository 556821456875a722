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
