"""The torch port owns every module it runs.

``circminer_tpu_torch`` (and ``chip_smoke.py``) import nothing of the JAX
reference ``circminer_tpu``, not even its host-only modules: what the port
shares with the reference in behaviour is kept in the port as a copy at the
reference's relative path, and the C++ engines are built from the port's
own ``native/*.cpp`` into ``build/circminer_tpu_torch/``.  The copies are
pinned here to their originals: identical but for import lines and the
named deviations (the library build path of the ``*_native.py`` bindings,
the torch device of stage 2's wave service, the process group of
``parallel/distributed.py``).  The CLI subprocesses of
``test_torch_nojax.py`` block the reference as they block jax; the ranks
of ``graft_entry.run_ranks`` check it themselves.
"""

import ast
import dataclasses
import difflib
import inspect
import os

import pytest

import circminer_tpu_torch
from circminer_tpu_torch import cli as tcli
from circminer_tpu_torch.config import Config as PortConfig
from circminer_tpu_torch.ops import _native
from circminer_tpu_torch.parallel import mesh as tmesh
from circminer_tpu_torch.utils import timing as ttiming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.dirname(circminer_tpu_torch.__file__)
REF = os.path.join(REPO, "circminer_tpu")

_BUILD = {"_HERE", "_SRC", "_ALIGN_SRC", "_CHAIN_SRC", "_CIRC_SRC", "_LIB",
          "_build"}
# relative path -> (top-level names left out on both sides, lines only the
# port has, lines only the reference has); lines compare stripped
DEVIATIONS = {
    "ops/seed_native.py": (_BUILD, (), ()),
    "ops/chain_native.py": (_BUILD, (), ()),
    "ops/filter_native.py": (_BUILD, (), ()),
    "ops/align_native.py": (_BUILD | {"__doc__"}, (), ()),
    "pipeline/circ.py": (
        set(),
        {"def __init__(self, db, gi, cfg: Config, output_prefix: str,",
         'device="cuda"):',
         "self.device = resolve_device(device)",
         "svc = DeviceAlignService(self.cfg, device=self.device)"},
        {"def __init__(self, db, gi, cfg: Config, output_prefix: str):",
         "svc = DeviceAlignService(self.cfg)"}),
    # a gloo process group in place of jax.distributed
    "parallel/distributed.py": (
        {"__doc__", "INIT_TIMEOUT"},
        {'"""Initialize torch.distributed when configured; returns',
         "# one gloo process group over every host (host 0 serves the store)",
         'dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",',
         "world_size=num_hosts, rank=host_id,", "timeout=INIT_TIMEOUT)"},
        {'"""Initialize jax.distributed when configured; returns',
         "# full jax.distributed runtime (device collectives across hosts)",
         "jax.distributed.initialize(coordinator_address=coordinator,",
         "num_processes=num_hosts,", "process_id=host_id)"}),
}
COPIES = ["config.py", "sim.py", "annotation/annotation.py",
          "index/__init__.py", "index/build.py", "index/mrsfast_format.py",
          "io/__init__.py", "io/fasta.py", "io/fastq.py", "io/gtf.py",
          "ops/align.py", "ops/align_native.py", "ops/chain_native.py",
          "ops/circ_native.py", "ops/encode.py", "ops/filter_native.py",
          "ops/seed_native.py", "pipeline/categories.py", "pipeline/circ.py",
          "pipeline/extend.py", "pipeline/extend_batch.py",
          "pipeline/mapping.py", "pipeline/output.py", "pipeline/types.py",
          "utils/logging.py", "parallel/distributed.py"]
NATIVE = ["align_kernels.cpp", "chain_kernels.cpp", "circ_kernels.cpp",
          "filter_kernels.cpp", "lookup_kernels.cpp"]


def port_config(cfg):
    """The port's own Config with the fields of ``cfg`` (a reference
    Config): the parity tests build their worlds with the reference and
    hand port code the port's Config, as the port's CLI does."""
    return PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)})


def test_port_config_takes_the_reference_fields():
    from circminer_tpu.config import Config
    ref = Config(kmer=20, max_read_len=100, band_width=5)
    port = port_config(ref)
    assert type(port) is PortConfig and port != ref   # never equal across
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert [f.name for f in dataclasses.fields(PortConfig)] == \
        [f.name for f in dataclasses.fields(Config)]


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(tree):
    """Every module an AST imports, at any depth, with relative imports
    left relative (``.``-prefixed); plus string arguments of
    ``importlib.import_module`` / ``__import__`` calls."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                ast.unparse(node.func) in ("importlib.import_module",
                                           "import_module", "__import__"):
            yield node.args[0].value


def test_port_never_imports_the_reference():
    n = 0
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"circminer_tpu_torch/graft_entry.py",
            "circminer_tpu_torch/parallel/mesh.py",
            "circminer_tpu_torch/parallel/distributed.py",
            "chip_smoke.py"} <= scanned
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imported_modules(tree):
            n += 1
            assert mod.split(".")[0] not in ("circminer_tpu", "jax",
                                             "jaxlib"), (path, mod)
    assert n > 100
    with open(os.path.join(PORT, "__init__.py")) as f:
        assert "sys.modules" not in f.read()   # no import surgery


def _comparable_lines(src, drop):
    """Non-blank lines of ``src`` without its import statements (any depth)
    and the top-level statements named in ``drop`` (``__doc__`` = the
    module docstring), stripped."""
    tree = ast.parse(src)
    cut = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            cut.update(range(node.lineno, node.end_lineno + 1))
    for i, node in enumerate(tree.body):
        names = set()
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = {node.name}
        elif isinstance(node, ast.Assign):
            names = {ast.unparse(t) for t in node.targets}
        elif i == 0 and isinstance(node, ast.Expr) and \
                isinstance(node.value, ast.Constant):
            names = {"__doc__"}
        if names & drop:
            first = min([node.lineno] + [d.lineno for d in getattr(
                node, "decorator_list", [])])
            cut.update(range(first, node.end_lineno + 1))
    return [ln.strip() for k, ln in enumerate(src.splitlines(), 1)
            if k not in cut and ln.strip()]


def _assert_copy(port_src, ref_src, drop=(), port_only=(), ref_only=()):
    a = _comparable_lines(ref_src, set(drop))
    b = _comparable_lines(port_src, set(drop))
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        extra_ref = [ln for ln in a[i1:i2] if ln not in ref_only]
        extra_port = [ln for ln in b[j1:j2] if ln not in port_only]
        assert not extra_ref and not extra_port, \
            f"reference {extra_ref[:3]} vs port {extra_port[:3]}"


@pytest.mark.parametrize("rel", COPIES + [f"native/{n}" for n in NATIVE])
def test_copy_is_the_reference_but_for_imports_and_named_deviations(rel):
    with open(os.path.join(PORT, rel), "rb") as f:
        port = f.read()
    with open(os.path.join(REF, rel), "rb") as f:
        ref = f.read()
    if rel.endswith(".cpp"):
        assert port == ref
        return
    _assert_copy(port.decode(), ref.decode(), *DEVIATIONS.get(rel, ((),)))


def _ref_source(rel, *names):
    with open(os.path.join(REF, rel)) as f:
        tree = ast.parse(f.read())
    nodes = [n for n in tree.body if isinstance(n, (ast.FunctionDef,
                                                    ast.ClassDef))
             and n.name in names]
    return "\n\n".join(ast.unparse(n) for n in nodes), len(nodes)


@pytest.mark.parametrize("rel,port_module,names", [
    ("parallel/mesh.py", tmesh, ("shard_index_arrays",)),
    ("cli.py", tcli, ("config_from_args", "run_index")),
    ("utils/timing.py", ttiming, ("PhaseTimer", "timed")),
])
def test_merged_parts_are_the_reference_source(rel, port_module, names):
    """Modules the port already had take the reference's functions
    verbatim (up to function-local imports)."""
    want, n = _ref_source(rel, *names)
    assert n == len(names)
    got = "\n\n".join(ast.unparse(ast.parse(inspect.getsource(
        getattr(port_module, name)))) for name in names)
    _assert_copy(got, want)
    assert isinstance(ttiming.GLOBAL_TIMER, ttiming.PhaseTimer)


def test_port_cli_takes_every_reference_flag():
    """The port's parser has every option of the reference's, with the
    same destinations and defaults (--device takes the port's executors)."""
    with open(os.path.join(REF, "cli.py")) as f:
        tree = ast.parse(f.read())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name == "build_parser"]
    ref_flags = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                ast.unparse(node.func) == "p.add_argument":
            opts = [a.value for a in node.args]
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg == "default"}
            ref_flags[tuple(opts)] = kw.get("default")
    port = {tuple(a.option_strings): a for a in tcli.build_parser()._actions}
    assert len(ref_flags) == 31
    for opts, default in ref_flags.items():
        assert opts in port, opts
        if opts != ("--device",) and default is not None:
            assert port[opts].default == default, opts


def test_native_engines_build_into_the_port_build_dir():
    """Each binding builds its library from the port's own sources into
    build/circminer_tpu_torch/, named by a hash of sources and flags, and
    leaves the reference's libraries alone."""
    from circminer_tpu_torch.ops import (align_native, chain_native,
                                         filter_native, seed_native)
    ref_so = sorted(f for f in os.listdir(os.path.join(REF, "native"))
                    if f.endswith(".so"))

    def stat_ref():
        return [os.stat(os.path.join(REF, "native", f)).st_mtime_ns
                for f in ref_so]
    before = stat_ref()
    for mod in (align_native, chain_native, filter_native, seed_native):
        assert mod._build()
        assert os.path.dirname(mod._LIB) == _native.BUILD_DIR
        assert os.path.dirname(mod._SRC) == _native.NATIVE_DIR
        assert os.path.exists(mod._LIB)
    assert stat_ref() == before
    assert _native.BUILD_DIR == os.path.join(REPO, "build",
                                             "circminer_tpu_torch")
    srcs = [filter_native._SRC, filter_native._CIRC_SRC]
    assert _native.library_path("x", srcs, []) != \
        _native.library_path("x", srcs, ["-pthread"])


def test_pipeline_takes_the_reference_signature():
    """DeviceMappingPipeline takes the reference's parameters and defaults
    (seg_pad, chain_exec="auto"), then the port's torch device."""
    from circminer_tpu.pipeline.device_pipeline import \
        DeviceMappingPipeline as Ref
    from circminer_tpu_torch.pipeline.device_pipeline import \
        DeviceMappingPipeline as Port

    def params(cls):
        return [(p.name, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]
    assert params(Port) == params(Ref) + [("device", "cuda")]
    assert dict(params(Port))["chain_exec"] == "auto"
    assert tcli.EXECUTORS["gpu-wave"] == ("auto", "device")
