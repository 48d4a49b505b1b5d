"""Host-side planning of the port's CUDA kernels, on the CPU.

1. ops/scan.py:split_plan, the corpus splits per query block: the plan the
   flat scans have always used on the H100 (2 splits at B=4096 over the
   31,744-row pack on 132 SMs), raised so that no split of the bf16 bank
   kernel holds 65,536 tiles or more (it keeps a kept row as a 16-bit tile
   index within its split, 0xFFFF meaning none).
2. ops/_cuda.py:kernel_resources, the registers and spill bytes per kernel
   read from nvcc's ptxas report, which chip_smoke.py prints per kernel, and
   chip_smoke.KERNEL_ENTRIES, the piece of each kernel's mangled name it
   looks for there: each must name a __global__ kernel of its source, so
   that a renamed kernel cannot leave its report "not built in this run".
3. The int8 hop kernel's byte conversion (csrc/hop.cu, dot8_int8), emulated
   in numpy with the constants read from the source: every signed byte in
   every position of its word becomes its exact value in f32.
"""

import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.ops import _cuda
from hnsw_tpu_torch.ops.scan import MAX_SPLIT_TILES, split_plan


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Light tests: two threads leave the other cores to the test workers
    that share the host (a timing test among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wave_plan(qblocks, ntiles, sms):
    """The plan before the tile cap: the split count in 1..16 that fills the
    SMs in the most even number of waves, the smallest on a tie."""
    best, best_eff = 1, 0.0
    for s in range(1, min(ntiles, 16) + 1):
        waves = qblocks * s / sms
        eff = waves / math.ceil(waves)
        if eff > best_eff + 1e-9:
            best, best_eff = s, eff
    return best


def _split_sizes(ntiles, splits):
    """Tiles per split, as the kernels cut [0, ntiles) (csrc/scan.cu)."""
    return [(s + 1) * ntiles // splits - s * ntiles // splits
            for s in range(splits)]


def test_split_plan_at_the_flat_scan_shape():
    # B = 4096 (64 query blocks) over 31,744 rows (248 tiles) on an H100
    assert split_plan(64, 248, 132) == 2
    # the int8 scans' 32,768-row pack and the floors' 16 units of nt = 2048
    assert split_plan(64, 256, 132) == 2
    assert split_plan(64, 16, 132) == 2


@pytest.mark.parametrize("qblocks,ntiles,sms", [
    (64, 248, 132), (16, 256, 132), (1, 1, 132), (2, 32, 132),
    (1, 65535, 132), (1, 65536, 132), (64, 65536 * 3 + 1, 132),
    (8, 1_000_000, 114), (1, 16 * 65535 + 7, 132), (200, 70_000, 132)])
def test_split_plan_keeps_every_split_below_65536_tiles(qblocks, ntiles, sms):
    s = split_plan(qblocks, ntiles, sms)
    assert s >= 1
    assert max(_split_sizes(ntiles, s)) <= MAX_SPLIT_TILES < 65536
    if ntiles <= 16 * MAX_SPLIT_TILES and \
            _wave_plan(qblocks, ntiles, sms) * MAX_SPLIT_TILES >= ntiles:
        # where the wave plan already fits, it is the plan
        assert s == _wave_plan(qblocks, ntiles, sms)
    else:
        # raised to the fewest splits that fit
        assert s == -(-ntiles // MAX_SPLIT_TILES)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3_GN24bucket_bank_wgmma_kernelILi0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN3_GN24bucket_bank_wgmma_kernelILi0EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN3_GN18bucket_bank_kernelILb1EEEvPKh' for 'sm_90a'
ptxas info    : Function properties for _ZN3_GN18bucket_bank_kernelILb1EEEvPKh
    304 bytes stack frame, 304 bytes spill stores, 596 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 304 bytes cumulative stack size, 33792 bytes smem
"""


def test_kernel_resources_reads_the_ptxas_report():
    got = _cuda.kernel_resources(PTXAS_LOG)
    assert got == {
        "_ZN3_GN24bucket_bank_wgmma_kernelILi0EEEvPKf": (168, 0),
        "_ZN3_GN18bucket_bank_kernelILb1EEEvPKh": (255, 900)}
    assert _cuda.kernel_resources("") == {}


REPO = pathlib.Path(__file__).resolve().parent.parent


def _kernel_entries():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNEL_ENTRIES


@pytest.mark.parametrize("name", sorted(_kernel_entries()))
def test_each_ptxas_piece_names_a_kernel_of_its_source(name):
    src, piece = _kernel_entries()[name]
    # <length><identifier>, then I...E for the template arguments
    m = re.fullmatch(r"(\d+)(\w*?)(I\w+E)?", piece)
    assert m, piece
    length, rest, targs = int(m.group(1)), m.group(2), m.group(3)
    ident = rest[:length]
    assert len(ident) == length and rest[length:] == "", piece
    code = (REPO / "hnsw_tpu_torch" / "csrc" / src).read_text()
    # the definition: [template <...>] __global__ ... ident(
    defn = re.search(r"(template\s*<[^>]*>\s*)?__global__[^;{]*?\b"
                     + ident + r"\s*\(", code)
    assert defn, f"{name}: no __global__ {ident} in csrc/{src}"
    # the piece is a prefix of the mangled name: template arguments, where
    # it gives them, need a template
    assert targs is None or defn.group(1) is not None, \
        f"{name}: {piece} has template arguments, its kernel none"


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (s >> 4i) & 7 of the eight bytes of x (0-3) and y (4-7)."""
    pool = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
        [(y >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= pool[(s >> (4 * i)) & 7] << (8 * i)
    return out


@pytest.mark.parametrize("j", range(4))
def test_int8_hop_byte_conversion_is_exact(j):
    code = (REPO / "hnsw_tpu_torch" / "csrc" / "hop.cu").read_text()
    m = re.search(r"raw\.x \^ (0x[0-9A-F]+)u.*?__byte_perm\(w\[h\], (0x[0-9A-F]+)u, "
                  r"(0x[0-9A-F]+) \+ j\)\),\s*([0-9.]+)f\)", code, re.S)
    assert m, "the conversion of dot8_int8 is not where this test reads it"
    flip, magic, sel = (int(m.group(i), 16) for i in (1, 2, 3))
    sub = float(m.group(4))
    rng = np.random.default_rng(j)
    b = np.arange(-128, 128)
    word = rng.integers(0, 2 ** 32, b.size, dtype=np.uint64).astype(np.uint32)
    word = (word & ~np.uint32(0xFF << (8 * j))) | \
        ((b.astype(np.int8).view(np.uint8).astype(np.uint32)) << (8 * j))
    bits = _byte_perm(word ^ np.uint32(flip), np.full_like(word, magic),
                      sel + j)
    got = bits.astype(np.uint32).view(np.float32) - np.float32(sub)
    np.testing.assert_array_equal(got, b.astype(np.float32))
