"""Parameter lists of the port against the JAX package, by AST; no import of
either package.

For every public function, and every public method or __init__ of a public
class, that a module of hnsw_tpu/ defines and its twin under
hnsw_tpu_torch/ defines too (tests/test_torch_api_faults.py holds that the
twin exists), the parameters' names, kinds, order and defaults must be the
same, except for the differences kept on purpose: the `device=None` the
port adds (ADDS_DEVICE) and the lists written out in KEPT, each with its
reason. A change on either side that is not listed fails, and so does a
listed difference that has gone.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWIN_PATH = {"ops/pallas_hop.py": "ops/hop.py",
             "ops/pallas_scan.py": "ops/scan.py"}

# the port's device=None (the CUDA card unless told otherwise); the list is
# the reference's with it left out
ADDS_DEVICE = {
    "api/simple.py::Index.load",
    "apps/shell.py::SearchShell.__init__",
    "bench/cli.py::demo",
    "bench/cli.py::full_benchmark",
    "bench/cli.py::main",
    "bench/cli.py::multiprobe_benchmark",
    "bench/cli.py::multithread_benchmark",
    "bench/cli.py::pcaf_benchmark",
    "bench/cli.py::quick_benchmark",
    "io/persist.py::load_index",
    "models/common.py::as_corpus",
    "models/flat.py::build_flat_index",
    "models/hnsw/__init__.py::build_hnsw_index",
    "models/hnsw/graph.py::empty_graph",
    "models/ivf_flat.py::build_ivf_flat_index",
    "models/ivf_hnsw.py::build_ivf_hnsw_index",
    "models/lightning.py::build_lightning_index",
    "models/lsh.py::build_lsh_index",
    "models/partitioned.py::build_partitioned_hnsw",
    "models/pcaf.py::build_pcaf_index",
    "parallel/build.py::build_partitioned_hnsw_sharded",
    "parallel/mesh.py::make_mesh",
    "parallel/mesh.py::make_mesh_2d",
    "types.py::Corpus.from_array",
    "types.py::Corpus.from_array_streamed",
}

# the port's list where it differs otherwise, and why
KEPT = {
    # each package's own float32
    "models/_partition_scan.py::PartitionTable.build":
        "cls, corpus, assign, centroids=None, secondary=None, "
        "dtype=torch.float32",
    # no hop_kernel: a used pack always goes through ops/hop.py
    "models/hnsw/__init__.py::HNSWIndex.__init__":
        "self, corpus, graph, *, expand=4, entry_mode='sample', "
        "entry_sample=512, precision='auto', pack='auto', pack_dim=None, "
        "rerank_mult=4, pack_precision='auto'",
    # the index's settings, passed on to __init__
    "models/hnsw/__init__.py::HNSWIndex.from_state":
        "cls, corpus, state, **kwargs",
    # the hop count, read from the card once after the result
    "models/hnsw/__init__.py::HNSWIndex.search_batch":
        "self, queries, k, mode=Mode.BALANCED, ef=None, debug_hops=False",
    # spill pools (ROADMAP §C); the reference's pools are spill=False
    "models/hnsw/build_large.py::build_layer_clustered":
        "vectors, v_sq, member_rows, *, cap, k_cand, metric, "
        "cluster_size=4096, n_probe_clusters=2, refine_rounds=1, seed=42, "
        "tile=1024, precision='bf16', spill=False, progress=None",
    # a wrapper of _search_batch (test_search_batch_takes_the_references_keywords)
    "models/hnsw/search.py::hnsw_search_batch":
        "*args, debug_hops=False, **kwargs",
    # no ef: it fed only the Pallas kernel's eligibility test
    "models/hnsw/search.py::prepare_hop_fast_path":
        "owner, corpus, adj0, *, expand, pack_bytes_cap",
    # the partition-stacked vectors may be absent (the sharded search
    # forms them)
    "models/partitioned.py::PartitionedHNSWIndex.__init__":
        "self, corpus, *, num_partitions, rows_p, adj0_p, adj_upper_p, "
        "entries_p, m, m0, ef_construction, seed=42, vectors_p=None, "
        "v_sq_p=None",
    # the projected table may be absent (formed from proj)
    "models/pcaf.py::PCAFIndex.__init__":
        "self, corpus, *, proj, n_components, low_vectors=None, "
        "low_sq=None, seed=42",
    # no Pallas knobs (tb, ring, interpret)
    "ops/pallas_hop.py::hop_score": "nbr_pack, queries, sel_rows",
    "ops/pallas_hop.py::hop_score_int8": "nbr_pack, queries, sel_rows",
    # under the temporary directory, not /tmp by name
    "utils/profiling.py::profile_trace": "log_dir=None",
}


def _render(fn, drop=()) -> str:
    """A parameter list as `name[=default]`, with `*`, `*args` and
    `**kwargs`; annotations left out."""
    a = fn.args
    pos = a.posonlyargs + a.args
    dflt = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    kw = list(zip(a.kwonlyargs, a.kw_defaults))
    one = [p.arg if d is None else f"{p.arg}={ast.unparse(d)}"
           for p, d in list(zip(pos, dflt)) + kw if p.arg not in drop]
    n_pos = sum(p.arg not in drop for p in pos)
    star = ["*" + a.vararg.arg] if a.vararg else (
        ["*"] if any(p.arg not in drop for p in a.kwonlyargs) else [])
    tail = ["**" + a.kwarg.arg] if a.kwarg else []
    return ", ".join(one[:n_pos] + star + one[n_pos:] + tail)


def _defs(path: pathlib.Path) -> dict:
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and \
                not node.name.startswith("_"):
            out.update((f"{node.name}.{m.name}", m) for m in node.body
                       if isinstance(m, ast.FunctionDef)
                       and (m.name == "__init__"
                            or not m.name.startswith("_")))
    return out


def _modules():
    ref = ROOT / "hnsw_tpu"
    return sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py"))


@pytest.mark.parametrize("rel", _modules())
def test_parameter_lists_match_the_reference(rel):
    twin = ROOT / "hnsw_tpu_torch" / TWIN_PATH.get(rel, rel)
    if not twin.exists():
        return
    ref, port = _defs(ROOT / "hnsw_tpu" / rel), _defs(twin)
    for name in sorted(ref.keys() & port.keys()):
        qual = f"{rel}::{name}"
        want, got = _render(ref[name]), _render(port[name])
        if qual in ADDS_DEVICE:
            assert _render(port[name], drop={"device"}) == want, qual
            assert "device=None" in got, qual
        elif qual in KEPT:
            assert want != got and got == KEPT[qual], qual
        else:
            assert got == want, qual
    listed = {q.split("::")[1] for q in ADDS_DEVICE | KEPT.keys()
              if q.startswith(rel + "::")}
    assert listed <= ref.keys() & port.keys(), rel


def test_search_batch_takes_the_references_keywords():
    """The port's _search_batch takes hnsw_search_batch's parameters of the
    reference, in order, but hop_kernel (no Pallas kernel to choose)."""
    rel = "models/hnsw/search.py"
    ref = _defs(ROOT / "hnsw_tpu" / rel)["hnsw_search_batch"]
    tree = ast.parse((ROOT / "hnsw_tpu_torch" / rel).read_text())
    port = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "_search_batch")
    assert _render(port) == _render(ref, drop={"hop_kernel"})
