"""The torch port's stage-2 device extension (circminer_tpu_torch/pipeline/
circ.py) against the JAX reference on the CPU.

The BSJ stream is tests/test_circ_device.py's (150 kbp, 6 genes, 5%
segmental duplications, linear + circular + short-fragment pairs mapped by
the native executor, sorted by genome position).  The port's
``ProcessCirc(device="cpu").run(device_ext=True)`` (the four DP kernels'
plain versions) must give the reference's ``run(device_ext=True)`` and the
per-read Python oracle's circ_res and candidate lines exactly, with the
same device / host request counts as the JAX wave service."""

import ast
import importlib.util
import inspect
import textwrap

import pytest
import torch

from circminer_tpu.pipeline.circ import ProcessCirc as JaxProcessCirc
from circminer_tpu_torch.pipeline.circ import ProcessCirc
from test_circ_device import _key, bsj_stream  # noqa: F401  (fixture)
from test_torch_selfcontained import port_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs stage 2 there)")
    return torch.device("cuda")


def test_port_stage2_matches_jax_and_oracle(bsj_stream, tmp_path):
    db, gi, cfg, bsj = bsj_stream
    assert len(bsj) > 50
    oracle = JaxProcessCirc(db, gi, port_config(cfg), str(tmp_path / "oracle"))
    oracle.run(list(bsj), native=False)
    ref = JaxProcessCirc(db, gi, port_config(cfg), str(tmp_path / "jax"))
    ref.run(list(bsj), device_ext=True)
    port = ProcessCirc(db, gi, port_config(cfg), str(tmp_path / "port"),
                       device="cpu")
    port.run(list(bsj), device_ext=True)

    want = [_key(c) for c in oracle.circ_res]
    assert want and [_key(c) for c in ref.circ_res] == want
    assert [_key(c) for c in port.circ_res] == want
    assert port.candid_lines == ref.candid_lines == oracle.candid_lines
    assert port.dev_align_stats == ref.dev_align_stats
    assert port.dev_align_stats["n_device"] > 0
    assert port.dev_align_stats["n_dispatch"] > 0


def _body(cls):
    """The statements of ``cls._run_device`` with its docstring, imports and
    the construction of the wave service (``svc = ...``) taken out."""
    fn = ast.parse(textwrap.dedent(inspect.getsource(cls._run_device))).body[0]
    keep = []
    for i, node in enumerate(fn.body):
        if i == 0 and isinstance(node, ast.Expr):
            continue
        if isinstance(node, ast.ImportFrom):
            continue
        if isinstance(node, ast.Assign) and \
                [ast.unparse(t) for t in node.targets] == ["svc"]:
            continue
        keep.append(ast.dump(node))
    return fn.args, keep


def test_run_device_is_the_reference_but_for_the_service():
    (port_args, port), (ref_args, ref) = _body(ProcessCirc), \
        _body(JaxProcessCirc)
    assert ast.dump(port_args) == ast.dump(ref_args)
    assert port == ref
    src = inspect.getsource(ProcessCirc._run_device)
    assert "svc = DeviceAlignService(self.cfg, device=self.device)" in src
    fn = ast.parse(textwrap.dedent(src)).body[0]
    (imp,) = [n for n in ast.walk(fn) if isinstance(n, ast.ImportFrom)
              and [a.name for a in n.names] == ["DeviceAlignService"]]
    assert importlib.util.resolve_name(
        "." * imp.level + imp.module, ProcessCirc.__module__.rsplit(
            ".", 1)[0]) == "circminer_tpu_torch.ops.align_device"


def test_no_silent_fallback_to_cpu(bsj_stream, tmp_path):
    db, gi, cfg, _ = bsj_stream
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ProcessCirc(db, gi, port_config(cfg), str(tmp_path / "x"),
                        device="cuda")
    assert ProcessCirc(db, gi, port_config(cfg), str(tmp_path / "y"),
                       device="cpu").device.type == "cpu"


@pytest.mark.cuda
def test_port_stage2_on_card_matches_host(bsj_stream, tmp_path, cuda_device):
    """The kernels on the card: stage 2 equal to the native host engine,
    with edit_sc launched."""
    from circminer_tpu_torch.ops import _ext
    db, gi, cfg, bsj = bsj_stream
    host = JaxProcessCirc(db, gi, port_config(cfg), str(tmp_path / "host"))
    host.run(list(bsj))
    _ext.reset_launches()
    port = ProcessCirc(db, gi, port_config(cfg), str(tmp_path / "card"),
                       device=cuda_device)
    port.run(list(bsj), device_ext=True)
    assert [_key(c) for c in port.circ_res] == \
        [_key(c) for c in host.circ_res]
    assert port.candid_lines == host.candid_lines
    assert _ext.LAUNCHES["edit_sc"] > 0
