"""The port's chip substrate against the JAX package's, bit for bit.

Mixers, randomization streams, CRCs, headers, page images and the
functional chip model must agree exactly (tolerance 0) on inputs made from
numpy seeds; data crosses between the packages as numpy.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import bits as jbits
from repro.core import ecc as jecc
from repro.core import randomize as jrand
from repro.core.commands import Command as JCommand
from repro.core.engine import SimChipArray as JSimChipArray
from repro.core.page import build_page as jbuild_page
from repro.core.page import mask_header_slots as jmask
from repro_torch.core import bits, ecc, randomize
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.core.page import build_page, mask_header_slots
from repro_torch.kernels.layout import words_to_tensor
from repro_torch.kernels.sim_search import ref as tref


def _u32(rng, n):
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    return x


@pytest.mark.parametrize("salt", [randomize._LO_SALT, randomize._HI_SALT])
def test_mix2_32_bit_equal_numpy_and_torch(salt):
    x = _u32(np.random.default_rng(salt & 0xFF), 100_000)
    want = jbits.mix2_32(x, salt)
    np.testing.assert_array_equal(bits.mix2_32(x, salt), want)
    t = tref.mix2_32(torch.from_numpy(x.astype(np.int64)), salt)
    np.testing.assert_array_equal(t.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(bits.fmix32(x), jbits.fmix32(x))


@pytest.mark.parametrize("page,seed", [(0, 0), (5, 31), (2**26 + 3, 7),
                                       (123_456, 0xFFFFFFFF)])
def test_stream_words_bit_equal(page, seed):
    want = jrand.stream_words(page, seed)
    np.testing.assert_array_equal(randomize.stream_words(page, seed), want)
    # the plain PyTorch stream the kernels' reference versions regenerate
    s_lo, s_hi = tref.stream_planes(
        words_to_tensor(np.array([page & 0xFFFFFFFF], np.uint32), "cpu"),
        words_to_tensor(np.array([seed], np.uint32), "cpu"))
    np.testing.assert_array_equal(s_lo[0].numpy().astype(np.uint32),
                                  want[:, 0])
    np.testing.assert_array_equal(s_hi[0].numpy().astype(np.uint32),
                                  want[:, 1])


def test_chunk_streams_bit_equal():
    rng = np.random.default_rng(3)
    pages = rng.integers(0, 4096, 50)
    chunks = rng.integers(0, 64, 50)
    seeds = rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        randomize.chunk_stream_words_batch(pages, chunks, seeds),
        jrand.chunk_stream_words_batch(pages, chunks, seeds))
    np.testing.assert_array_equal(randomize.chunk_stream_words(9, 4, 11),
                                  jrand.chunk_stream_words(9, 4, 11))


@pytest.mark.parametrize("n_bytes", [0, 7, 64, 127, 128, 4096, 5000])
def test_crcs_bit_equal(n_bytes):
    data = np.random.default_rng(n_bytes).integers(
        0, 256, n_bytes).astype(np.uint8)
    assert ecc.crc32(data) == jecc.crc32(data)
    assert ecc.crc64(data) == jecc.crc64(data)
    rows = np.random.default_rng(n_bytes + 1).integers(
        0, 256, (9, 64)).astype(np.uint8)
    np.testing.assert_array_equal(ecc.crc32_rows(rows), jecc.crc32_rows(rows))
    np.testing.assert_array_equal(ecc.crc64_rows(rows), jecc.crc64_rows(rows))


@pytest.mark.parametrize("randomized", [False, True])
@pytest.mark.parametrize("n_entries", [0, 17, 504])
def test_page_images_bit_equal(n_entries, randomized):
    rng = np.random.default_rng(n_entries)
    entries = rng.integers(1, 2**63, n_entries, dtype=np.uint64)
    user = rng.integers(0, 2**32, (5, 2), dtype=np.uint64).astype(np.uint32)
    kw = dict(timestamp_ns=123_456_789, header_user=user, device_seed=42,
              randomize=randomized)
    a, b = build_page(entries, 77, **kw), jbuild_page(entries, 77, **kw)
    for f in ("raw", "plain", "chunk_parities"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.page_addr, a.timestamp_ns, a.n_entries) == \
        (b.page_addr, b.timestamp_ns, b.n_entries)
    np.testing.assert_array_equal(ecc.build_header_chunk(5, user),
                                  jecc.build_header_chunk(5, user))


def test_mask_header_slots_and_bitmaps_equal():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 2**32, (4, 16), dtype=np.uint64).astype(
        np.uint32)
    np.testing.assert_array_equal(mask_header_slots(words), jmask(words))
    np.testing.assert_array_equal(bits.unpack_bitmap(words, 500),
                                  jbits.unpack_bitmap(words, 500))
    np.testing.assert_array_equal(
        bits.chunk_bitmap_from_slot_bitmap(words),
        jbits.chunk_bitmap_from_slot_bitmap(words))
    np.testing.assert_array_equal(bits.popcount_words(words),
                                  jbits.popcount_words(words))


def test_chip_model_search_and_gather_equal():
    """The functional chip model (striping, latch pipeline, counters)
    answers a search and a gather exactly as the JAX package's does."""
    rng = np.random.default_rng(12)
    port, ref = SimChipArray(3, 8, device_seed=5), JSimChipArray(3, 8, 5)
    keys = [rng.integers(1, 2**62, 300, dtype=np.uint64) for _ in range(10)]
    for p, k in enumerate(keys):
        port.program_entries(p, k)
        ref.program_entries(p, k)
    for p in (0, 4, 9):
        q = int(keys[p][100])
        a = port.search(Command.search(p, q))
        b = ref.search(JCommand.search(p, q))
        np.testing.assert_array_equal(a.bitmap_words, b.bitmap_words)
        assert (a.match_count, a.open_verdict) == (b.match_count,
                                                   b.open_verdict)
        g, h = (port.gather(Command.gather(p, 0b1011 << 20)),
                ref.gather(JCommand.gather(p, 0b1011 << 20)))
        np.testing.assert_array_equal(g.chunks, h.chunks)
        np.testing.assert_array_equal(g.chunk_ids, h.chunk_ids)
        np.testing.assert_array_equal(g.parity_ok, h.parity_ok)
    for c, d in zip(port.chips, ref.chips):
        assert vars(c.counters) == vars(d.counters)


# ------------------------------------------------------------ import guards

ROOT = Path(__file__).resolve().parents[1]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_repro(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
            f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.frontend, repro_torch.convert, "
            "repro_torch.backend, repro_torch.kernels.native, "
            "repro_torch.analysis.__main__, "
            "repro_torch.analysis.launch_audit, "
            "repro_torch.analysis.conservation; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
