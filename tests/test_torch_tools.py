"""Port of the tools (hnsw_tpu_torch/io/loader.py, io/native.py,
bench/cli.py, apps/shell.py, utils/) against the JAX package's, on the CPU.

Twins of tests/test_apps.py, tests/test_native.py and the loader cases of
tests/test_io.py; tests/test_bench_utils.py::test_timer_utils has none, as
the port's spans (utils/tracing.py, tests/test_torch_tracing.py) replace
Timer and timed, and profile_trace shows them here. Each case writes its
own small JSON corpus; the port's loader, native parser and shell give arrays, ids, texts, metadata and result rows identical to the
JAX package's on the same file. The native library is built only under
hnsw_tpu_torch/_build/ (never into native/).
"""

import json
import os

import numpy as np
import pytest
import torch

from hnsw_tpu.apps.shell import SearchShell as JShell
from hnsw_tpu.io import loader as jloader
from hnsw_tpu.io import native as jnative

from hnsw_tpu_torch.apps.shell import SearchShell
from hnsw_tpu_torch.bench import cli
from hnsw_tpu_torch.io import loader, native
from hnsw_tpu_torch.utils import tracing
from hnsw_tpu_torch.utils.profiling import profile_trace

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: many small CPU operators run about as fast, and the
    test workers that share the host keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_bible(path, n=60, d=24):
    """tests/test_apps.py's corpus: verses with text."""
    rng = np.random.default_rng(0)
    verses = []
    for i in range(n):
        emb = rng.standard_normal(d)
        emb /= np.linalg.norm(emb)
        verses.append({"id": f"Gen_1:{i}", "text": f"verse number {i} words",
                       "embedding": emb.tolist()})
    with open(path, "w") as f:
        json.dump({"metadata": {}, "verses": verses}, f)


def _write_corpus(path, n=50, d=12, with_text=True):
    """tests/test_native.py's corpus: quoted text with escaped newlines."""
    rng = np.random.default_rng(3)
    verses = []
    for i in range(n):
        v = {"id": f"Bk_{i}:1",
             "embedding": rng.standard_normal(d).round(6).tolist()}
        if with_text:
            v["text"] = f'verse "quoted" number {i}\nwith newline'
        verses.append(v)
    with open(path, "w") as f:
        json.dump({"metadata": {"dimensions": d}, "verses": verses}, f)
    return verses


def _same_load(got, want):
    """(pairs, texts, metadata) identical."""
    (gp, gt, gm), (wp, wt, wm) = got, want
    assert [p[0] for p in gp] == [p[0] for p in wp]
    for a, b in zip(gp, wp):
        assert a[1].dtype == b[1].dtype == np.float32
        np.testing.assert_array_equal(a[1], b[1])
    assert gt == wt and gm == wm


@pytest.fixture
def large_files(monkeypatch):
    """Both loaders take the "large file" branch (the native parser)."""
    import os.path
    monkeypatch.setattr(os.path, "getsize", lambda _: 10 << 20)


# ---------------------------------------------------------------------------
# the shell and the bench CLI (tests/test_apps.py)
# ---------------------------------------------------------------------------

def test_shell_seed_and_query(tmp_path, capsys):
    p = str(tmp_path / "corpus.json")
    _write_bible(p)
    jshell = JShell(p, index_type="flat")
    shell = SearchShell(p, index_type="flat", **CPU)
    assert shell.find_seed("number 7 ") == jshell.find_seed("number 7 ") \
        == "Gen_1:7"
    qvec = shell.data[shell.id_pos["Gen_1:7"]]
    want = jshell.index.search(qvec, 3, jshell.mode)
    got = shell.index.search(qvec, 3, shell.mode)
    assert [h["id"] for h in got] == [h["id"] for h in want]
    np.testing.assert_allclose([h["distance"] for h in got],
                               [h["distance"] for h in want], atol=1e-5)
    capsys.readouterr()
    shell.query("number 7 ", k=3)
    out = capsys.readouterr().out
    assert "Gen_1:7" in out and "%" in out
    shell.stats()
    assert "flat" in capsys.readouterr().out

    from hnsw_tpu_torch.config import Mode
    shell.mode = Mode.TURBO
    shell.recall()
    assert "recall@10" in capsys.readouterr().out


def test_shell_synthetic_fallback(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)     # no corpus on the fallback chain
    jshell = JShell(None, index_type="flat", n_synthetic=80)
    shell = SearchShell(None, index_type="flat", n_synthetic=80, **CPU)
    assert shell.data.shape[0] == 80
    np.testing.assert_array_equal(shell.data, jshell.data)
    assert shell.find_seed("doc_5") == "doc_5"
    _, want = jshell.index.search_batch(shell.data[:4], 5)
    _, got = shell.index.search_batch(shell.data[:4], 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shell_run_reads_its_commands(tmp_path, monkeypatch, capsys):
    p = str(tmp_path / "corpus.json")
    _write_bible(p)
    shell = SearchShell(p, index_type="flat", **CPU)
    lines = iter(["number 3 ", "mode 1", "stats", "quit"])
    monkeypatch.setattr("builtins.input", lambda _: next(lines))
    shell.run()
    out = capsys.readouterr().out
    assert "Gen_1:3" in out and "mode = turbo" in out and "bye" in out


def test_cli_demo_mode(monkeypatch, capsys):
    monkeypatch.setattr(cli, "load_or_generate",
                        lambda n, dim=768: _unit(n, 48))
    rc = cli.main(["demo", "lightning", "300", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "lightning" in out and "recall@10" in out
    assert cli.main(["no-such-mode"], **CPU) == 1


def _unit(n, d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((min(n, 300), d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# the native parser (tests/test_native.py)
# ---------------------------------------------------------------------------

def test_native_builds():
    assert native.get_lib() is not None, "g++ build of fast_corpus failed"


def test_native_matches_python_and_jax(tmp_path):
    p = str(tmp_path / "c.json")
    verses = _write_corpus(p)
    emb, ids, texts = native.parse_corpus(p)
    jemb, jids, jtexts = jnative.parse_corpus(p)
    np.testing.assert_array_equal(emb, jemb)
    assert ids == jids == [v["id"] for v in verses]
    assert texts == jtexts
    np.testing.assert_allclose(
        emb, np.asarray([v["embedding"] for v in verses], np.float32),
        rtol=1e-6)
    assert "quoted" in texts[0] and "\n" not in texts[0]


def test_loader_uses_native_for_large_files(tmp_path, large_files):
    p = str(tmp_path / "big.json")
    _write_corpus(p, n=200, d=64)
    got = loader.load_json_corpus(p)
    assert len(got[0]) == 200 and got[0][5][0] == "Bk_5:1"
    assert got[0][5][1].shape == (64,)
    _same_load(got, jloader.load_json_corpus(p))


def test_loader_falls_back_on_schema_mismatch(tmp_path, large_files):
    p = str(tmp_path / "odd.json")
    with open(p, "w") as f:
        json.dump({"vectors": [{"id": "x", "embedding": [1.0, 2.0]},
                               {"id": "y", "embedding": [3.0]}]}, f)  # ragged
    assert native.parse_corpus(p) is None
    got = loader.load_json_corpus(p)
    assert got[0][0][0] == "x"
    _same_load(got, jloader.load_json_corpus(p))


def test_native_build_writes_only_under_build(tmp_path, monkeypatch):
    """A fresh build goes to <BUILD_DIR>/libfastcorpus_<digest>.so by way
    of a renamed temporary, and leaves native/ as it was."""
    assert native.BUILD_DIR.name == "_build"
    assert native.BUILD_DIR.parent.name == "hnsw_tpu_torch"
    src_dir = native.SRC_PATH.parent
    before = {f: os.stat(src_dir / f).st_mtime_ns
              for f in os.listdir(src_dir)}
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    assert native.get_lib() is not None
    built = os.listdir(tmp_path / "_build")
    assert built == [native._lib_path().name]
    assert built[0].startswith("libfastcorpus_")
    assert {f: os.stat(src_dir / f).st_mtime_ns
            for f in os.listdir(src_dir)} == before


# ---------------------------------------------------------------------------
# the loader (tests/test_io.py) and the timers (tests/test_bench_utils.py)
# ---------------------------------------------------------------------------

def test_json_corpus_loader(tmp_path):
    corpus = {
        "metadata": {"model": "test"},
        "verses": [
            {"id": "Gen_1:1", "text": "In the beginning",
             "embedding": [0.1, 0.2]},
            {"id": "Gen_1:2", "text": "And the earth",
             "embedding": [0.3, 0.4]},
        ],
    }
    p = str(tmp_path / "bible.json")
    with open(p, "w") as f:
        json.dump(corpus, f)
    got = loader.load_json_corpus(p)
    assert got[0][0][0] == "Gen_1:1"
    np.testing.assert_allclose(got[0][1][1], [0.3, 0.4])
    assert got[1]["Gen_1:1"] == "In the beginning"
    assert got[2]["model"] == "test"
    _same_load(got, jloader.load_json_corpus(p))


def test_fallback_chain(tmp_path):
    assert loader.get_best_available_data(base_dir=str(tmp_path)) is None
    assert loader.DEFAULT_CANDIDATES == jloader.DEFAULT_CANDIDATES
    with open(tmp_path / "b.json", "w") as f:
        json.dump({"vectors": [{"id": "x", "embedding": [1.0]}]}, f)
    (tmp_path / "a.json").write_text("{not json")
    kw = dict(candidates=["missing.json", "a.json", "b.json"],
              base_dir=str(tmp_path))
    found = loader.get_best_available_data(**kw)
    want = jloader.get_best_available_data(**kw)
    assert found is not None and found[0][0][0] == "x"
    assert found[3] == want[3]
    _same_load(found[:3], want[:3])


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profile_trace(str(tmp_path)) as log_dir:
        with tracing.span("hnsw_span"):
            torch.ones(8) @ torch.ones(8)
    assert log_dir == str(tmp_path)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "hnsw_span"
               for e in trace["traceEvents"])
