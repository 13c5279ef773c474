"""The port's public surface against the JAX package's, read with ``ast``.

Every module of ``src/repro`` has a twin under the same path in
``src/repro_torch`` (``*_jax.py`` as ``*_torch.py``), and every public
top-level def and class of a reference module, and every name a
reference ``__init__.py`` re-exports from the package, is a top-level
name of the twin: defined, assigned or imported there.  Each public
method of a public reference class is bound in the twin's class of that
name (a ``Module``'s ``init``/``apply`` as ``__init__``/``forward``).
Imports of other packages (``jnp``, ``pl``, ``lax``, typing) are not
re-exports and are not compared, nor are module constants or call
signatures (the port's take no parameter pytree, PRNG key or
``interpret`` flag).  The exceptions are
:data:`KEPT`, each with the port's name for it (if it has one) and the
reason; each is listed in ``ROADMAP.md``'s Queue A, and an entry that no
longer names a difference fails, as a stale analyzer baseline entry does.
The package exports are also imported, so that a documented name that
raises ``ImportError`` fails here.  Last, the names this completes:
``nn.layers.LayerNorm`` and ``Embedding`` against the reference's on its
carried-over parameters, and the HLO collective parsers
(``launch.hlo_analysis.top_collectives``, ``launch.roofline.
collective_bytes``) against the reference's on the same text."""

import ast
import importlib
import os
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# (reference module, public name) -> (the port's name for it, or None;
# why the twin differs)
KEPT = {
    ("nn/module.py", "Module"): (
        None, "torch.nn.Module replaces the reference's init/apply module "
              "over parameter pytrees"),
    ("nn/module.py", "Sequential"): (
        None, "a torch.nn.Module calls its children itself; "
              "torch.nn.Sequential where a chain is wanted"),
    ("nn/module.py", "Lambda"): (
        None, "a function called in a module's forward"),
    ("core/nsga2_jax.py", "jit_nsga2"): (
        "torch_nsga2", "the generation loop is eager tensor code on a "
                       "device, not one jax.jit program"),
    ("core/nsga2_jax.py", "jit_nsga2_restarts"): (
        "torch_nsga2_restarts", "the restarts run in turn and their fronts "
                                "merge, not vmapped into one program"),
    ("core/nsga2_jax.py", "make_jit_runner"): (
        None, "it builds the compiled jax.jit program; eager PyTorch "
              "compiles nothing"),
    ("core/nsga2_jax.py", "make_jit_restart_runner"): (
        None, "as make_jit_runner, for the vmapped restarts"),
    ("explore/strategies.py", "JitNSGA2Search"): (
        "TorchNSGA2Search", "strategy 'torch_nsga2'; a spec's 'jit_nsga2' "
                            "loads as it (SearchSettings.REFERENCE_NAMES)"),
    ("explore/__init__.py", "JitNSGA2Search"): (
        "TorchNSGA2Search", "the package export of the strategy above"),
    ("explore/strategies.py", "clear_jit_runner_cache"): (
        None, "no runner cache: nothing is compiled"),
    ("explore/__init__.py", "clear_jit_runner_cache"): (
        None, "no runner cache: nothing is compiled"),
    ("explore/strategies.py", "jit_runner_cache_size"): (
        None, "no runner cache: nothing is compiled"),
    ("explore/__init__.py", "jit_runner_cache_size"): (
        None, "no runner cache: nothing is compiled"),
    ("kernels/ops.py", "resolve_rank_impl"): (
        "resolve_impl", "every kernel resolves its impl from the tensor's "
                        "device; the REPRO_RANK_IMPL override that sends "
                        "'auto' to Pallas in interpret mode on a CPU has "
                        "no CUDA counterpart (a CUDA kernel has no "
                        "interpret mode)"),
    ("analysis/taint.py", "jit_regions"): (
        "capture_regions", "torch.compile, torch.jit and CUDA-graph "
                           "regions in place of jax.jit and lax regions"),
    ("analysis/rules_trace.py", "python_branch_on_tracer"): (
        "python_branch_on_tensor", "RPR101 -> RPT101 on capture regions"),
    ("analysis/rules_trace.py", "host_sync_in_jit"): (
        "host_sync_in_capture", "RPR102 -> RPT102 on capture regions"),
    ("analysis/rules_trace.py", "jit_in_loop"): (
        "capture_in_loop", "RPR103 -> RPT103"),
    ("analysis/rules_trace.py", "missing_donation"): (
        None, "RPR104 has no counterpart: eager PyTorch donates no buffer"),
    ("analysis/rules_kernel.py", "block_shape_divisibility"): (
        "unchecked_launch", "RPR201 (Pallas BlockSpec divisibility) -> "
                            "RPT203, every launch result checked"),
    ("analysis/rules_kernel.py", "index_map_arity"): (
        "launch_arity", "RPR202 -> RPT202, launch arity against argtypes"),
    ("analysis/rules_kernel.py", "hardcoded_interpret"): (
        "hardcoded_ref_impl", "RPR203 -> RPT204, no literal impl='ref'"),
    ("analysis/rules_kernel.py", "pallas_call_outside_kernels"): (
        "launch_outside_kernels", "RPR204 -> RPT201, loads and launches "
                                  "in kernels/ only"),
    ("analysis/taint.py", "Region.param_names"): (
        "Region.seeds", "a region's tainted names are found when it is made "
                        "(a CUDA-graph block has no parameters), not read "
                        "from a traced def's arguments less its static ones"),
    ("core/partition.py", "PartitionEvaluator.jax_tables"): (
        "PartitionEvaluator.torch_tables", "the cost tables as tensors on "
                                           "a device the caller names"),
}

# the reference's Module (a kept difference above) initialises and applies
# a parameter pytree by ``init`` and ``apply``; its torch.nn.Module twin
# does both in its constructor and ``forward``
MODULE_METHODS = {"init": "__init__", "apply": "forward"}


def twin_of(rel: str) -> str:
    return rel[:-len("_jax.py")] + "_torch.py" if rel.endswith("_jax.py") \
        else rel


def public_names(path: Path, package: str) -> set:
    """The public top-level defs and classes of ``path``, and for an
    ``__init__.py`` the names it imports from ``package``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and (node.level or (node.module or "").split(".")[0]
                   == package)):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def module_names(path: Path) -> set:
    """Every name bound at the top level of ``path`` (in ``if``/``try``
    blocks too): what ``from module import name`` finds."""
    out = set()

    def scan(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                out.update((a.asname or a.name).split(".")[0]
                           for a in node.names)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                out.update(n.id for t in targets for n in ast.walk(t)
                           if isinstance(n, ast.Name))
            elif isinstance(node, (ast.If, ast.Try)):
                scan(node.body)
                scan(node.orelse)
                for h in getattr(node, "handlers", []):
                    scan(h.body)

    scan(ast.parse(path.read_text(), filename=str(path)).body)
    return out


def missing(ref_path: Path, twin_path: Path, ref_rel: str) -> list:
    """Public names of the reference module that its twin lacks, less the
    kept differences."""
    have = module_names(twin_path)
    return sorted(n for n in public_names(ref_path, "repro")
                  if n not in have and (ref_rel, n) not in KEPT)


def class_members(path: Path) -> dict:
    """Each top-level class of ``path``: (its bases as written, its defs,
    every name its body binds: defs, assignments and annotated fields)."""
    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if not isinstance(node, ast.ClassDef):
            continue
        defs, bound = set(), set()
        for b in node.body:
            if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.add(b.name)
            elif isinstance(b, ast.Assign):
                bound.update(t.id for t in b.targets
                             if isinstance(t, ast.Name))
            elif isinstance(b, ast.AnnAssign) and \
                    isinstance(b.target, ast.Name):
                bound.add(b.target.id)
        out[node.name] = ([ast.unparse(x) for x in node.bases], defs,
                          defs | bound)
    return out


def public_methods(path: Path) -> set:
    """``Class.method`` for each public def of each public class."""
    return {f"{c}.{m}" for c, (_, defs, _) in class_members(path).items()
            if not c.startswith("_") for m in defs if not m.startswith("_")}


def class_names(path: Path) -> set:
    """``Class.name`` for each name bound in each class body."""
    return {f"{c}.{n}" for c, (_, _, bound) in class_members(path).items()
            for n in bound}


def missing_methods(ref_path: Path, twin_path: Path, ref_rel: str) -> list:
    """Public methods of the reference's public classes that the twin's
    class of that name does not bind, less the kept differences and the
    ``init``/``apply`` of a ``Module`` whose twin defines
    :data:`MODULE_METHODS`' replacement.  A class the twin lacks is
    :func:`missing`'s to report."""
    twin = class_members(twin_path)
    lost = []
    for cls, (bases, defs, _) in class_members(ref_path).items():
        if cls.startswith("_") or cls not in twin:
            continue
        have = twin[cls][2]
        for m in sorted(defs):
            if m.startswith("_") or m in have or \
                    (ref_rel, f"{cls}.{m}") in KEPT:
                continue
            if "Module" in bases and MODULE_METHODS.get(m) in have:
                continue
            lost.append(f"{cls}.{m}")
    return lost


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
REF_CLASS_MODULES = [m for m in REF_MODULES if public_methods(REF / m)]
REF_PACKAGES = [m for m in REF_MODULES if m.endswith("__init__.py")]


def test_the_reference_has_its_116_modules():
    assert len(REF_MODULES) == 116


@pytest.mark.parametrize("rel", REF_MODULES)
def test_twin_exists_with_the_reference_names(rel):
    twin = PORT / twin_of(rel)
    assert twin.exists(), f"no twin of src/repro/{rel}"
    lost = missing(REF / rel, twin, rel)
    assert not lost, f"src/repro_torch/{twin_of(rel)} lacks {lost}"


@pytest.mark.parametrize("rel", REF_CLASS_MODULES)
def test_twin_classes_have_the_reference_methods(rel):
    lost = missing_methods(REF / rel, PORT / twin_of(rel), rel)
    assert not lost, f"src/repro_torch/{twin_of(rel)} lacks {lost}"


@pytest.mark.parametrize("rel", REF_PACKAGES)
def test_package_exports_import(rel):
    """Each name the reference package re-exports imports from the port's
    package (the runtime form of the check above)."""
    package = "repro_torch" + "".join(
        f".{p}" for p in Path(rel).parent.parts)
    mod = importlib.import_module(package)
    lost = sorted(n for n in public_names(REF / rel, "repro")
                  if (rel, n) not in KEPT and not hasattr(mod, n))
    assert not lost, f"{package} does not export {lost}"


def test_documented_exports_import():
    """The package exports README.md names, once missing from the
    port's ``__init__`` files."""
    from repro_torch.data import batch_iterator, make_batch_for
    from repro_torch.quantize import qat_finetune
    from repro_torch.serving import SlotDecoder
    assert all(callable(f) for f in (batch_iterator, make_batch_for,
                                     qat_finetune, SlotDecoder))


def _queue_a() -> str:
    """ROADMAP's Queue A (faults found in the port against the reference;
    named Queue 3 before the queues took letters) to the end of the
    queues."""
    text = (ROOT / "ROADMAP.md").read_text()
    return text[text.index("### Queue A"):text.index("## Recent")]


@pytest.mark.parametrize("key", sorted(KEPT), ids=lambda k: "::".join(k))
def test_kept_difference_is_still_needed(key):
    """The reference still has the name, the twin still lacks it, the
    port's replacement exists, and ROADMAP Queue A names it with its
    reason."""
    rel, name = key
    port_name, reason = KEPT[key]
    assert reason
    assert name in public_names(REF / rel, "repro") | public_methods(
        REF / rel), f"stale entry: src/repro/{rel} has no public {name}"
    have = module_names(PORT / twin_of(rel)) | class_names(
        PORT / twin_of(rel))
    assert name not in have, \
        f"stale entry: src/repro_torch/{twin_of(rel)} has {name}"
    if port_name is not None:
        assert port_name in have, (twin_of(rel), port_name)
    assert f"`{name}`" in _queue_a(), f"ROADMAP Queue A does not name {name}"


def test_scanner_reports_a_missing_export(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref, port = tmp_path / "ref" / "__init__.py", tmp_path / "port" / \
        "__init__.py"
    ref.write_text("import numpy as np\nfrom jax import jit\n"
                   "from repro.a import f, g as h\nfrom .b import K\n"
                   "def _private(): pass\nclass C: pass\n")
    port.write_text("from repro_torch.a import f\ntry:\n    K = 1\n"
                    "except ImportError:\n    pass\n")
    assert missing(ref, port, "x/__init__.py") == ["C", "h"]


def test_scanner_reports_a_missing_method(tmp_path):
    ref, port = tmp_path / "ref.py", tmp_path / "port.py"
    ref.write_text("class A(Module):\n    def init(self): pass\n"
                   "    def apply(self): pass\n    def f(self): pass\n"
                   "    def _g(self): pass\n"
                   "class B:\n    def h(self): pass\n"
                   "    def k(self): pass\n"
                   "class C(Module):\n    def apply(self): pass\n"
                   "class D:\n    def f(self): pass\n")
    port.write_text("class A(nn.Module):\n    def __init__(self): pass\n"
                    "    def forward(self): pass\n"
                    "class B:\n    h = 1\n"
                    "class C(nn.Module):\n    def apply2(self): pass\n")
    assert missing_methods(ref, port, "x.py") == ["A.f", "B.k", "C.apply"]


# -- the names this slice added ---------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_matches_reference(bias):
    """``nn.layers.LayerNorm`` on the reference's ``{"scale", "bias"}``
    carried over by ``load_reference_cnn``."""
    jnp = pytest.importorskip("jax.numpy")
    import torch
    from repro.nn.layers import LayerNorm as JLayerNorm
    from repro_torch.models.convert import load_reference_cnn
    from repro_torch.nn.layers import LayerNorm

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    params, _ = JLayerNorm(48, bias=bias).init(None)
    params = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()}
    want, _ = JLayerNorm(48, eps=1e-5, bias=bias).apply(params, {},
                                                         jnp.asarray(x))
    ln = load_reference_cnn(LayerNorm(48, bias=bias, device="cpu"), params)
    assert sorted(n for n, _ in ln.named_parameters()) == sorted(params)
    np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=2e-5, atol=1e-6)


def test_embedding_matches_reference():
    """``nn.layers.Embedding`` on the reference's ``{"table"}``; its own
    initialisation is N(0, std^2) from the generator given."""
    jnp = pytest.importorskip("jax.numpy")
    import torch
    from repro.nn.layers import Embedding as JEmbedding
    from repro_torch.models.convert import load_reference_cnn
    from repro_torch.nn.layers import Embedding

    rng = np.random.default_rng(1)
    table = rng.standard_normal((97, 24)).astype(np.float32)
    ids = rng.integers(0, 97, (4, 13))
    want, _ = JEmbedding(97, 24).apply({"table": table}, {},
                                       jnp.asarray(ids))
    emb = load_reference_cnn(Embedding(97, 24, device="cpu"),
                             {"table": table})
    np.testing.assert_allclose(emb(torch.from_numpy(ids)).numpy(),
                               np.asarray(want), rtol=2e-5)
    drawn = Embedding(1000, 64, std=0.5,
                      generator=torch.Generator().manual_seed(0)).table
    again = Embedding(1000, 64, std=0.5,
                      generator=torch.Generator().manual_seed(0)).table
    assert drawn.shape == (1000, 64) and not drawn.requires_grad
    assert torch.equal(drawn, again)
    assert abs(float(drawn.std()) - 0.5) < 0.01
    assert abs(float(drawn.mean())) < 0.01


# a scan over a product whose contracting axis is sharded over four host
# devices: XLA puts an all-reduce in the while body (trip count 5)
_SHARDED = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(jax.devices(), ("d",))
def f(x, w):
    y, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None,
                        length=5)
    return y.sum(0)
x = jax.device_put(jnp.ones((64, 32)), NamedSharding(mesh, P(None, "d")))
w = jax.device_put(jnp.ones((32, 32)), NamedSharding(mesh, P("d", None)))
print(jax.jit(f).lower(x, w).compile().as_text())
"""

# every collective kind, a tuple result, metadata, a fusion called from a
# while body with a known trip count
_HANDWRITTEN = "\n".join([
    "HloModule m",
    "%fused (a: f32[8,16]) -> f32[2,16] {",
    "  %a = f32[8,16]{1,0} parameter(0)",
    "  ROOT %rs = f32[2,16]{1,0} reduce-scatter(%a), dimensions={0}, "
    'to_apply=%add, metadata={op_name="scatter_grads"}',
    "}",
    "%body (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {",
    "  %p = (s32[], f32[8,16]{1,0}) parameter(0)",
    "  %x = f32[8,16]{1,0} get-tuple-element(%p), index=1",
    "  %a2a = bf16[8,16]{1,0} all-to-all(%x), dimensions={0}, "
    'metadata={op_name="dispatch"}',
    "  %f = f32[2,16]{1,0} fusion(%x), kind=kLoop, calls=%fused",
    "  ROOT %t = (s32[], f32[8,16]{1,0}) tuple(%i, %x)",
    "}",
    "ENTRY %main (p: f32[8,16]) -> f32[8,16] {",
    "  %p = f32[8,16]{1,0} parameter(0)",
    "  %all-gather.3 = bf16[16,512]{1,0} all-gather(%p), "
    'metadata={op_name="gather_w"}',
    "  %ar = (f32[8,16]{1,0}, f32[4]{0}) all-reduce(%p, %p), to_apply=%add",
    "  %w = (s32[], f32[8,16]{1,0}) while(%t0), condition=%cond, "
    'body=%body, backend_config={"known_trip_count":{"n":"6"}}',
    "  ROOT %cp = f32[8,16]{1,0} collective-permute(%p)",
    "}"])


# collectives of types outside the roofline parser's byte table, which
# counts them 4 bytes each where ``top_collectives`` counts their width
_NARROW = "\n".join([
    "HloModule n",
    "ENTRY %main (p: f32[4,4]) -> f32[4,4] {",
    "  %p = f32[4,4]{1,0} parameter(0)",
    "  %ag = f8e4m3fn[4,4]{1,0} all-gather(%p)",
    "  %ar = (s4[8]{0}, f32[2]{0}) all-reduce(%p, %p), to_apply=%add",
    "  ROOT %cp = f32[4,4]{1,0} collective-permute(%p)",
    "}"])


@pytest.fixture(scope="module")
def hlo_texts():
    pytest.importorskip("jax")
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _SHARDED],
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return {"sharded": out.stdout, "handwritten": _HANDWRITTEN,
            "narrow": _NARROW}


@pytest.mark.parametrize("name", ["sharded", "handwritten", "narrow"])
def test_collective_parsers_equal_the_reference(hlo_texts, name):
    """``top_collectives`` and ``roofline.collective_bytes`` give exactly
    the reference's result on the same dumped text."""
    from repro.launch import hlo_analysis as jhlo
    from repro.launch import roofline as jroofline
    from repro_torch.launch import hlo_analysis, roofline

    text = hlo_texts[name]
    for k in (1, 15):
        assert hlo_analysis.top_collectives(text, k) == \
            jhlo.top_collectives(text, k)
    assert roofline.collective_bytes(text) == \
        jroofline.collective_bytes(text)
    top = hlo_analysis.top_collectives(text)
    if name == "sharded":
        # the all-reduce of the (64, 32) float32 product, 5 times
        assert [t[:2] for t in top] == [(5 * 64 * 32 * 4, "all-reduce")]
        assert roofline.collective_bytes(text)["all-reduce"] == 64 * 32 * 4
    elif name == "narrow":
        assert roofline.collective_bytes(text)["all-gather"] == 16 * 4
        # the reference's first pattern takes a tuple's first shape only
        assert roofline.collective_bytes(text)["all-reduce"] == 8 * 4
        assert ("all-gather", 16) in [(t[1], t[0]) for t in top]
    else:
        assert [(t[1], t[2]) for t in top] == [
            ("all-gather", "gather_w"), ("all-to-all", "dispatch"),
            ("reduce-scatter", "scatter_grads"), ("all-reduce", "?"),
            ("collective-permute", "?")]
        assert top[1][0] == 6 * 8 * 16 * 2 and top[2][0] == 6 * 2 * 16 * 4
