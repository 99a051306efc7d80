"""The ctypes bindings of csrc/*.cu and the launch path (``ops._cuda.Entry``), on the CPU.

Each ``_SIGNATURES`` entry is held to its ``extern "C"`` declaration, parsed
from the source: a slip in the argument count or in a pointer's width shows
on the card only as a cut pointer or a wrong argument, so it is caught here.
``Entry`` raises on a CPU tensor before it loads the library, and importing
the modules that hold entries touches no CUDA. Over a stand-in library and
tensor, ``Entry`` is held to what it passes the C entry (the arguments in
order, then the device index and the stream's raw handle), to resolving the
function once, and to raising on a non-zero status.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from demuxalot_tpu_torch.ops import _cuda

_DECLARATION = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _ctype(parameter: str):
    """The ctypes type a C parameter (type and name) must be passed as."""
    kind = parameter.rsplit(None, 1)[0] if "*" not in parameter else "*"
    return {"*": ctypes.c_void_p, "int64_t": ctypes.c_int64, "int": ctypes.c_int, "float": ctypes.c_float}[kind]


def _declarations() -> dict:
    found = {}
    for source in _cuda.sources():
        for name, parameters in _DECLARATION.findall(source.read_text()):
            found[name] = tuple(_ctype(p.strip()) for p in parameters.split(","))
    return found


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_signature_matches_its_extern_c_declaration(name):
    declared = _declarations()
    assert name in declared, f"{name} has no extern \"C\" declaration in csrc/*.cu"
    assert len(_cuda._SIGNATURES[name]) == len(declared[name]), "argument count"
    assert _cuda._SIGNATURES[name] == declared[name], "argument types"


def test_every_extern_c_declaration_has_a_signature():
    assert sorted(_declarations()) == sorted(_cuda._SIGNATURES)


def test_entry_raises_on_a_cpu_tensor_before_loading_the_library(monkeypatch):
    monkeypatch.setattr(_cuda, "_library", None)
    monkeypatch.setattr(_cuda, "library", lambda: pytest.fail("a CPU tensor must not load the library"))
    entry = _cuda.Entry("demux_tiny")
    x = torch.ones(8, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        entry(x, x.data_ptr(), x.numel(), x.data_ptr())
    with pytest.raises(KeyError, match="not an entry point"):
        _cuda.Entry("demux_no_such_kernel")


def test_importing_the_entries_touches_no_cuda():
    """In a fresh process whose CUDA initialisation raises: the modules import, and no library is loaded."""
    script = f"""
import sys
sys.path.insert(0, {str(Path(__file__).resolve().parent.parent)!r})
import torch
def refuse(*args, **kwargs):
    raise AssertionError("CUDA touched at import")
torch.cuda._lazy_init = refuse
torch.cuda.init = refuse
from demuxalot_tpu_torch.ops import _cuda
from demuxalot_tpu_torch.experiments import dma_pattern, folded_estep, gather_forms, gather_operand, inkernel_gather
from demuxalot_tpu_torch.experiments import kernel_gather
from demuxalot_tpu_torch.ops import aggregate_kernel, likelihood_kernel, mstep_kernel
assert not torch.cuda.is_initialized()
assert _cuda._library is None and _cuda._build is None
assert gather_forms._take_along_axis._fn is None and gather_operand._tiny._fn is None
assert folded_estep._folded._fn is None and kernel_gather._gather_sum._fn is None
assert inkernel_gather._estep_banded._fn is None and inkernel_gather._mstep_banded._fn is None
assert inkernel_gather._check_banded._fn is None and gather_forms._cluster_gather_sum._fn is None
assert not gather_forms._CARD_PLANS and dma_pattern._stream_sum._fn is None
assert aggregate_kernel._aggregate._fn is None and aggregate_kernel._check_on_card._fn is None
assert likelihood_kernel._estep._fn is None and likelihood_kernel._check_on_card._fn is None
assert mstep_kernel._addition._fn is None and mstep_kernel._update._fn is None
assert mstep_kernel._check_on_card._fn is None and kernel_gather._gather_rows._fn is None
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


class _OnCard:
    """A stand-in for a CUDA tensor on card ``index``: all ``Entry`` reads of the tensor it launches on."""

    def __init__(self, index: int):
        self.index = index

    def get_device(self) -> int:
        return self.index


class _Library:
    """A stand-in kernel library: each entry records its arguments and returns ``status``."""

    def __init__(self, status: int = 0):
        self.status, self.calls, self.loads = status, [], 0

    def __getattr__(self, name):
        self.loads += 1

        def entry(*args):
            self.calls.append((name, args))
            return self.status
        return entry


def _stand_in(monkeypatch, status: int = 0) -> _Library:
    lib = _Library(status)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    # the raw stream handle of card i: a made-up pointer that names the card
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0x7F00_0000_0000 + index,
                        raising=False)
    return lib


@pytest.mark.parametrize("index", [0, 3])
@pytest.mark.parametrize("name, args", [("demux_tiny", (0x7F12_3456_7000, 1024, 0x7E00_0000_0040)),
                                        ("demux_take_along_axis", (0x7F12_3456_7000, 8192, 128, 0x7F12_0000_1230,
                                                                   4096, 128, 1, 0x7E00_0000_0040)),
                                        ("demux_gather_sum", (0x7F12_3456_7000, 8192, 64, 0x7F12_0000_1230,
                                                              1 << 20, 4096, 820, 10, 13, 0x7E00_0000_0040,
                                                              0x7E00_0000_2840)),
                                        ("demux_folded_logits", (0x7F12_3456_7000, 4_194_304, 32, 0x7F12_0000_1230,
                                                                 65_536, 0x7F11_0000_0000, 2, 0x7F10_0000_0000,
                                                                 528, 0x7E00_0000_0040, 1)),
                                        ("demux_estep_logits_banded", (0x7F12_3456_7000, 131_072, 32, 0x7F12_0000_1230,
                                                                       12, 0x7F11_0000_0000, 0x7F10_0000_0000,
                                                                       0x7F0F_0000_0000, 65_536, 0x7F0E_0000_0000,
                                                                       0x7F0D_0000_0000, 1, 528, 0x7E00_0000_0040)),
                                        ("demux_mstep_addition_banded", (0x7F12_3456_7000, 528, 32, 0x7F12_0000_1230,
                                                                         82, 0x7F11_0000_0000, 0x7F10_0000_0000,
                                                                         0x7F0F_0000_0000, 131_072, 2.0,
                                                                         0x7E00_0000_0040)),
                                        ("demux_banded_check", (0x7F12_0000_1230, 82, 65_536, 0x7F11_0000_0000,
                                                                131_072, 4_194_304, 0x7F10_0000_0000, None, 0, 24,
                                                                1, 1)),
                                        ("demux_cluster_gather_sum", (0x7F12_3456_7000, 8192, 32, 0x7F12_0000_1230,
                                                                      4_194_304, 8192, 5, 16, 0x7E00_0000_0040,
                                                                      0x7E00_0080_0040)),
                                        ("demux_stream_sum", (0x7F12_3456_7000, 32, 4_456_448, 1, 512, 128, 1, 256,
                                                              6, 0x7E00_0000_0040, 8704, 0x7E00_0000_8840)),
                                        ("demux_estep_logits", (0x7F12_3456_7000, 32, 0x7F12_0000_1230,
                                                                0x7F11_0000_0000, 0x7F10_0000_0000, 65_536,
                                                                0x7F0F_0000_0000, 0x7F0E_0000_0000, 1, 528, None,
                                                                0x7E00_0000_0040, 0x7E00_0210_0040)),
                                        ("demux_mstep_check", (0x7F12_0000_1230, 131_072, 4_194_304,
                                                               0x7F11_0000_0000, 65_536)),
                                        ("demux_mstep_addition", (0x7F12_3456_7000, 528, 32, 0x7F12_0000_1230,
                                                                  0x7F11_0000_0000, 0x7F10_0000_0000,
                                                                  0x7F0F_0000_0000, 0x7F0E_0000_0000, 100_000,
                                                                  0x7F0D_0000_0000, 0x7F0C_0000_0000,
                                                                  0x7F0B_0000_0000, 0x7F0A_0000_0000, 2.0,
                                                                  0x7E00_0000_0040)),
                                        ("demux_mstep_update", (0x7F12_3456_7000, 528, 32, 0x7F12_0000_1230,
                                                                0x7F11_0000_0000, 0x7F10_0000_0000, 0x7F0F_0000_0000,
                                                                0x7F0E_0000_0000, 100_000, 0x7F0D_0000_0000,
                                                                0x7F0C_0000_0000, 0x7F0B_0000_0000, 0x7F0A_0000_0000,
                                                                2.0, 0x7F09_0000_0000, None, 1e-10, 0.01, 0.99,
                                                                0x7E00_0000_0040, 0x7E00_0080_0040)),
                                        ("demux_gather_rows", (0x7F12_3456_7000, 8192, 64, 0x7F12_0000_1230, 1 << 20,
                                                               0x7E00_0000_0040))])
def test_entry_passes_its_arguments_then_the_device_and_the_stream(monkeypatch, name, args, index):
    lib = _stand_in(monkeypatch)
    entry = _cuda.Entry(name)
    entry(_OnCard(index), *args)
    assert lib.calls == [(name, (*args, index, 0x7F00_0000_0000 + index))]
    assert len(args) + 2 == len(_cuda._SIGNATURES[name]), "the C arguments, then the device and the stream"


def test_entry_resolves_its_function_once(monkeypatch):
    lib = _stand_in(monkeypatch)
    entry = _cuda.Entry("demux_tiny")
    for _ in range(5):
        entry(_OnCard(0), 1, 2, 3)
    assert lib.loads == 1 and len(lib.calls) == 5


def test_entry_raises_on_a_failed_launch(monkeypatch):
    _stand_in(monkeypatch, status=700)  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="demux_tiny: CUDA launch failed with cudaError_t 700"):
        _cuda.Entry("demux_tiny")(_OnCard(0), 1, 2, 3)
