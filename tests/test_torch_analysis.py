"""repro_torch.analysis, the port's static analyzer: every case of the JAX
package's suite (tests/test_analysis.py) has a counterpart here.

* RPR000, RPR3xx and RPR4xx are carried over as they are: the JAX suite's
  fixtures through both analyzers give equal (rule, line, col, context),
  the RPR4xx ones under each package's own scope, and both baseline
  loaders read the same file to the same entries.
* RPT1xx (capture safety) fire on seeded fixtures and stay silent on clean
  twins.
* RPT2xx (CUDA launch contracts) fire on copies of the port's real kernel
  wrappers with one contract broken, and stay silent on the unmodified
  copies.
* The gate: ``src/repro_torch``, ``chip_smoke.py`` and ``chip_profile.py``
  are clean under ``.analysis-baseline-torch.json``; the CLI runs with
  torch and jax blocked."""

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro.analysis import baseline as ref_baseline
from repro.analysis.cli import main as ref_cli_main
from repro_torch.analysis import (BaselineError, all_rules, analyze_paths,
                                  apply_baseline, load_baseline,
                                  write_baseline)
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.rules_kernel import kernel_wrappers
from test_analysis import (RPR101_BAD, RPR102_BAD, RPR104_BAD, RPR104_CLEAN,
                           RPR301_BAD, RPR301_CLEAN, RPR302_BAD, RPR302_CLEAN,
                           RPR303_BAD, RPR303_CLEAN, RPR401_BAD, RPR401_CLEAN,
                           RPR402_BAD, RPR402_CLEAN)

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "src" / "repro_torch"
KERNELS = PORT / "kernels"
GATE_PATHS = [PORT, REPO_ROOT / "chip_smoke.py", REPO_ROOT / "chip_profile.py"]
BLOCKED_MAIN = ("import runpy, sys; sys.modules['torch'] = None; "
                "sys.modules['jax'] = None; "
                "sys.argv = ['repro_torch.analysis'] + sys.argv[1:]; "
                "runpy.run_module('repro_torch.analysis', run_name='__main__')")


def place(tmp_path, source, relpath):
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return p


def run_rules(tmp_path, source, select, relpath="mod.py"):
    place(tmp_path, source, relpath)
    findings, _ = analyze_paths([str(tmp_path)], root=str(tmp_path),
                                select=[select])
    return findings


def run_ref(tmp_path, source, select, relpath="mod.py"):
    place(tmp_path, source, relpath)
    findings, _ = ref_analysis.analyze_paths(
        [str(tmp_path)], root=str(tmp_path), select=[select])
    return findings


def rule_ids(findings):
    return sorted({f.rule for f in findings})


def keys(findings):
    return [(f.rule, f.line, f.col, f.context) for f in findings]


def both(tmp_path, source, select, ref_rel="mod.py", port_rel="mod.py"):
    """The port's findings, after checking they equal the JAX package's
    on the same source (rule, line, col, context)."""
    port = run_rules(tmp_path / "port", source, select, port_rel)
    ref = run_ref(tmp_path / "ref", source, select, ref_rel)
    assert keys(port) == keys(ref)
    return port


# -- registry -----------------------------------------------------------------

def test_rule_catalog():
    rules = all_rules()
    ids = [r.id for r in rules]
    assert len(ids) == len(set(ids))
    for family in ("RPT1", "RPT2", "RPR3", "RPR4"):
        assert any(i.startswith(family) for i in ids), family
    assert ids == sorted(ids)
    # the carried-over families keep the JAX package's ids one for one
    ref_ids = [r.id for r in ref_analysis.all_rules()]
    assert [i for i in ids if i.startswith(("RPR3", "RPR4"))] == \
        [i for i in ref_ids if i.startswith(("RPR3", "RPR4"))]
    assert not any(i.startswith(("RPR1", "RPR2")) for i in ids)


def test_select_unknown_prefix_raises():
    for prefix in ("RPT9", "RPR1"):
        with pytest.raises(ValueError, match="matches no rule"):
            analyze_paths([str(PORT / "analysis")], select=[prefix])


# -- RPT101: python control flow on device values -----------------------------

RPT101_BAD = """
import torch

@torch.compile
def f(x, y):
    if x.sum() > 0:
        y = y + 1
    while y.max() > 0:
        y = y - 1
    z = x if x.mean() > 0 else -x
    return y + z

def build():
    return torch.compile(lambda x: x + 1 if x.sum() > 0 else x)

def capture(g, static_x):
    with torch.cuda.graph(g):
        y = torch.relu(static_x)
        for row in y:
            static_x.add_(row)
"""

RPT101_CLEAN = """
import torch

@torch.compile
def f(x, y=None):
    if y is None:                      # identity check: capture-safe
        y = torch.zeros_like(x)
    if x.ndim == 2:                    # shape attr: fixed while capturing
        x = x[None]
    for i in range(x.size(0)):         # size(): fixed
        x = x + y[i]
    return torch.where(x > 0, x, -x)   # the device branch, done right

@torch.compile
def g(x, n: int, flag: bool):
    # scalar-annotated parameters are guards, not device values
    if flag and n > 2:
        x = x * n
    if x.shape[-1] % 2 and x.is_cuda:
        x = x[..., :-1]
    return x

class Step(torch.nn.Module):
    @torch.compile
    def forward(self, x):
        if self.training:              # a module attribute, not a tensor
            x = x * 2
        return x

def eager(x):
    if x.sum() > 0:                    # not a capture region at all
        return x
    return -x

def capture(g, static_x, steps: int):
    with torch.cuda.graph(g):
        for _ in range(steps):
            static_x.mul_(2)
"""


def test_rpt101_fires(tmp_path):
    findings = run_rules(tmp_path, RPT101_BAD, "RPT101")
    assert rule_ids(findings) == ["RPT101"]
    msgs = " ".join(f.message for f in findings)
    assert "`if`" in msgs and "`while`" in msgs and "`for`" in msgs
    assert "conditional expression" in msgs
    assert any("torch.compile arg" in f.message for f in findings)
    assert any("torch.cuda.graph" in f.message for f in findings)
    assert len(findings) == 5


def test_rpt101_clean_twin_silent(tmp_path):
    assert run_rules(tmp_path, RPT101_CLEAN, "RPT101") == []


# -- RPT102: host syncs -------------------------------------------------------

RPT102_BAD = """
import numpy as np
import torch

TABLE = torch.arange(16)

@torch.compile
def f(x):
    a = np.asarray(x)            # device->host
    b = float(x.sum())           # a Python number of a device value
    c = x.max().item()
    torch.cuda.synchronize()
    return a, b, c

def capture(g, static_x, out):
    with torch.cuda.graph(g):
        y = static_x * 2
        out.append(y.cpu())
        n = y.sum().tolist()
        host = TABLE.numpy()     # untainted, but every sync counts here
"""

RPT102_CLEAN = """
import numpy as np
import torch

TABLE = np.arange(16)

@torch.compile
def f(x):
    t = torch.as_tensor(TABLE)   # host constant closed over, not synced
    n = float(x.shape[0])        # shape is fixed
    return x * n + t[0]

def host_side(x):
    torch.cuda.synchronize()     # not a capture region at all
    return x.cpu().numpy(), x.item()

def replay(g, static_x, out):
    with torch.cuda.graph(g):
        out.copy_(static_x * 2)
    g.replay()
    return out.cpu()             # after the capture block
"""


def test_rpt102_fires(tmp_path):
    findings = run_rules(tmp_path, RPT102_BAD, "RPT102")
    assert rule_ids(findings) == ["RPT102"]
    msgs = " ".join(f.message for f in findings)
    for what in ("numpy.asarray", "float()", ".item()",
                 "torch.cuda.synchronize()", ".cpu()", ".tolist()",
                 ".numpy()"):
        assert what in msgs, what
    assert len(findings) == 7


def test_rpt102_clean_twin_silent(tmp_path):
    assert run_rules(tmp_path, RPT102_CLEAN, "RPT102") == []


# -- RPT103: capture objects built in a loop ----------------------------------

RPT103_BAD = """
import torch

def run_all(fns, x):
    outs = []
    for fn in fns:
        outs.append(torch.compile(fn)(x))      # recompiles every iteration
    return outs

def record(n):
    graphs = []
    while len(graphs) < n:
        graphs.append(torch.cuda.CUDAGraph())
    return graphs

def graphed(models, xs):
    for m, x in zip(models, xs):
        m = torch.cuda.make_graphed_callables(m, (x,))
"""

RPT103_CLEAN = """
import torch

def run_all(fns, x):
    compiled = [torch.compile(fn) for fn in fns]   # once each
    g = torch.cuda.CUDAGraph()
    out = x
    for fn in compiled:
        out = fn(out)                               # calling in a loop: fine
    for _ in range(3):
        g.replay()
    return out

def factories(items):
    for it in items:
        def make():
            return torch.compile(it)                # runs when called
        yield make
"""


def test_rpt103_fires(tmp_path):
    findings = run_rules(tmp_path, RPT103_BAD, "RPT103")
    assert rule_ids(findings) == ["RPT103"]
    assert len(findings) == 3


def test_rpt103_clean_twin_silent(tmp_path):
    assert run_rules(tmp_path, RPT103_CLEAN, "RPT103") == []


# -- RPR104 (buffer donation) has no counterpart ------------------------------

def test_rpr104_has_no_counterpart(tmp_path):
    """Eager PyTorch has no donation: no rule of the port reads the JAX
    package's donation fixture."""
    assert not any("donat" in r.title for r in all_rules())
    findings, _ = analyze_paths(
        [str(place(tmp_path, RPR104_BAD, "mod.py"))], root=str(tmp_path))
    assert findings == []


def test_jit_regions_are_not_capture_regions(tmp_path):
    """The JAX package's jit fixtures (and the donation clean twin) hold
    no capture region of the port, so RPT1xx stays silent on them."""
    for i, src in enumerate((RPR101_BAD, RPR102_BAD, RPR104_CLEAN)):
        assert run_rules(tmp_path / str(i), src, "RPT1") == []


# -- RPT2xx: the port's kernel wrappers, unbroken and broken ------------------

KERNEL_FILES = sorted(p.name for p in KERNELS.glob("*.py"))


def real(name):
    return (PORT / name).read_text()


def sub(pattern, repl, source, flags=0):
    out, n = re.subn(pattern, repl, source, flags=flags)
    assert n == 1, f"mutation anchor {pattern!r} matched {n} times"
    return out


def replace(old, new, source):
    assert source.count(old) == 1, f"mutation anchor {old!r}"
    return source.replace(old, new)


def wrap_launch_in_fallback(source):
    """window_attn.py with its launch in a try whose handler runs the
    plain version."""
    start = source.index("    with torch.cuda.device(q.device):\n")
    end = source.index("    if code != 0:\n")
    block = textwrap.indent(source[start:end], "    ")
    return (source[:start] + "    try:\n" + block
            + "    except OSError:\n"
            "        return _ref.window_attn_gqa(q, k, v, window)\n"
            + source[end:])


def bump_before_check(source):
    source = replace("    window_attn.launches += 1\n", "", source)
    return replace("    if code != 0:\n",
                   "    window_attn.launches += 1\n    if code != 0:\n",
                   source)


OPS_FALLBACK = """    try:
        return _wa.window_attn(q, k, v, window)
    except RuntimeError:
        return _ref.window_attn_gqa(q, k, v, window)
"""

# (id, real file under src/repro_torch, where the broken copy sits, the
# contract broken, the findings expected of the RPT2 family)
MUTATIONS = [
    ("unchecked-launch", "kernels/window_attn.py", None,
     lambda s: sub(r"\n    if code != 0:\n(?:        .*\n)+", "\n", s),
     {"RPT203": 1}),
    ("unchecked-launch-qmm", "kernels/quant_matmul.py", None,
     lambda s: sub(r"\n    if code != 0:\n(?:        .*\n)+", "\n", s),
     {"RPT203": 1}),
    ("helper-call-dropped", "kernels/pareto_rank.py", None,
     lambda s: replace('    _check(lib, code, "packed_domination")\n', "", s),
     {"RPT203": 1}),
    ("helper-does-not-raise", "kernels/pareto_rank.py", None,
     lambda s: replace('        raise RuntimeError(f"{what} launch failed: "',
                       '        print(f"{what} launch failed: "', s),
     {"RPT203": 3}),
    ("surplus-launch-argument", "kernels/ssd_scan.py", None,
     lambda s: replace("b, t, h, p, n, chunk, stream)",
                       "b, t, h, p, n, chunk, chunk, stream)", s),
     {"RPT202": 1}),
    ("argtypes-grown", "kernels/quant_matmul.py", None,
     lambda s: replace("[_p] * 6 + [_i] * 4 + [_p]",
                       "[_p] * 6 + [_i] * 5 + [_p]", s),
     {"RPT202": 1}),
    ("counter-deleted", "kernels/window_attn.py", None,
     lambda s: replace("    window_attn.launches += 1\n", "", s),
     {"RPT206": 1}),
    ("counter-of-another-wrapper", "kernels/pareto_rank.py", None,
     lambda s: replace("    domination_counts.launches += 1",
                       "    packed_domination.launches += 1", s),
     {"RPT206": 2}),
    ("counter-before-check", "kernels/window_attn.py", None,
     bump_before_check, {"RPT206": 1}),
    ("counter-in-dispatch", "kernels/ops.py", None,
     lambda s: replace("    return _wa.window_attn(q, k, v, window)\n",
                       "    _wa.window_attn.launches += 1\n"
                       "    return _wa.window_attn(q, k, v, window)\n", s),
     {"RPT206": 1}),
    ("lib-at-import", "kernels/window_attn.py", None,
     lambda s: s + "\n_lib()\n", {"RPT205": 1}),
    ("build-at-import", "kernels/_build.py", None,
     lambda s: s + "\nbuild_all()\n", {"RPT205": 1}),
    ("launch-fallback", "kernels/window_attn.py", None,
     wrap_launch_in_fallback, {"RPT207": 1}),
    ("dispatch-fallback", "kernels/ops.py", None,
     lambda s: replace("    return _wa.window_attn(q, k, v, window)\n",
                       OPS_FALLBACK, s),
     {"RPT207": 1}),
    ("device-by-is-available", "explore/runner.py", None,
     lambda s: replace("    dev = torch.device(device)\n",
                       "    dev = torch.device(device if "
                       "torch.cuda.is_available() else 'cpu')\n", s),
     {"RPT207": 1}),
    ("wrapper-outside-kernels", "kernels/window_attn.py", "nn/window_attn.py",
     lambda s: s, {"RPT201": 2, "RPT206": 1}),
    ("ref-impl-hardcoded", "nn/attention.py", None,
     lambda s: replace("kops.window_attn(q, k, v, self.window, impl=impl)",
                       'kops.window_attn(q, k, v, self.window, impl="ref")',
                       s),
     {"RPT204": 1}),
    ("ref-impl-hardcoded-search", "core/nsga2_torch.py", None,
     lambda s: replace("ops.packed_domination(F, CV, impl=rank_impl)",
                       'ops.packed_domination(F, CV, impl="ref")', s),
     {"RPT204": 1}),
]


@pytest.mark.parametrize("name", KERNEL_FILES)
def test_rpt2_silent_on_the_ports_kernels(tmp_path, name):
    """The unmodified kernel modules (the four wrappers, ops.py, ref.py,
    _build.py) keep every launch contract."""
    findings = run_rules(tmp_path, real(f"kernels/{name}"), "RPT2",
                         f"src/repro_torch/kernels/{name}")
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("case", MUTATIONS, ids=[m[0] for m in MUTATIONS])
def test_rpt2_fires_on_a_broken_copy(tmp_path, case):
    _, source_rel, placed_rel, mutate, want = case
    findings = run_rules(tmp_path, mutate(real(source_rel)), "RPT2",
                         f"src/repro_torch/{placed_rel or source_rel}")
    got = {}
    for f in findings:
        got[f.rule] = got.get(f.rule, 0) + 1
    assert got == want, [f.render() for f in findings]


def test_rpt201_silent_inside_kernels(tmp_path):
    # the same wrapper that fires RPT201 under nn/ is where it belongs here
    assert run_rules(tmp_path, real("kernels/window_attn.py"), "RPT201",
                     "src/repro_torch/kernels/window_attn.py") == []
    # and a root script such as chip_variants.py is outside the family
    assert run_rules(tmp_path / "root", real("kernels/window_attn.py"),
                     "RPT2", "chip_variants.py") == []


def test_rpt202_evaluates_the_wrappers_list_forms(tmp_path):
    """``[x] * k`` and ``+`` count exactly; a dynamic form stays silent."""
    src = textwrap.dedent("""
        import ctypes
        _p, _i = ctypes.c_void_p, ctypes.c_int
        N = 3

        def _lib(lib):
            lib.a_launch.argtypes = [_p] * 10 + [_i] * 6 + [_p]
            lib.b_launch.argtypes = 2 * [_p] + (_i, _i)
            lib.c_launch.argtypes = [_p] * N
            lib.d_launch.argtypes = [*[_p], _i]
            return lib

        def run(lib, xs):
            for code in (lib.a_launch(*xs), lib.b_launch(1, 2, 3),
                         lib.c_launch(1), lib.d_launch(1, 2, 3, 4)):
                if code != 0:
                    raise RuntimeError(code)
            return lib.a_launch(*range(17)) and 0
    """)
    findings = run_rules(tmp_path, src, "RPT202",
                         "src/repro_torch/kernels/mod.py")
    assert [f.message.split("`")[1] for f in findings] == ["b_launch"]
    assert "3 arguments but its argtypes declares 4" in findings[0].message


def test_kernel_wrappers_are_the_five_counted_ones():
    assert kernel_wrappers(str(KERNELS)) == [
        "repro_torch.kernels.fake_quant.fake_quant_tensors",
        "repro_torch.kernels.mbconv_dw.mbconv_dw",
        "repro_torch.kernels.pareto_rank.domination_counts",
        "repro_torch.kernels.pareto_rank.packed_domination",
        "repro_torch.kernels.pareto_rank.peel_fronts",
        "repro_torch.kernels.quant_matmul.quant_matmul",
        "repro_torch.kernels.ssd_scan.ssd_scan",
        "repro_torch.kernels.window_attn.window_attn",
    ]


# -- RPR301-303: carried over, equal to the JAX package's ---------------------

def test_rpr301_fires(tmp_path):
    findings = both(tmp_path, RPR301_BAD, "RPR301")
    assert rule_ids(findings) == ["RPR301"]
    assert len(findings) == 2
    msgs = " ".join(f.message for f in findings)
    assert "repro_torch.utils.atomicio.atomic_write" in msgs


def test_rpr301_clean_twin_silent(tmp_path):
    assert both(tmp_path, RPR301_CLEAN, "RPR301") == []


def test_rpr302_fires(tmp_path):
    findings = both(tmp_path, RPR302_BAD, "RPR302")
    assert rule_ids(findings) == ["RPR302"]
    assert "dir=" in findings[0].message


def test_rpr302_clean_twin_silent(tmp_path):
    assert both(tmp_path, RPR302_CLEAN, "RPR302") == []


def test_rpr303_fires(tmp_path):
    findings = both(tmp_path, RPR303_BAD, "RPR303")
    assert rule_ids(findings) == ["RPR303"]
    assert "O_CREAT|O_EXCL" in findings[0].message


def test_rpr303_clean_twin_silent(tmp_path):
    assert both(tmp_path, RPR303_CLEAN, "RPR303") == []


# -- RPR401/402: the same rules, each package's own scope ---------------------

def test_rpr401_fires(tmp_path):
    findings = both(tmp_path, RPR401_BAD, "RPR401",
                    "src/repro/serve/mod.py", "src/repro_torch/serve/mod.py")
    assert rule_ids(findings) == ["RPR401"]
    assert len(findings) == 2
    msgs = " ".join(f.message for f in findings)
    assert "time.time()" in msgs and "perf_counter" in msgs
    assert "assigned from time.time" in msgs


def test_rpr401_clean_twin_silent(tmp_path):
    assert both(tmp_path, RPR401_CLEAN, "RPR401",
                "src/repro/fleet/mod.py", "src/repro_torch/fleet/mod.py") == []


def test_rpr401_out_of_scope_silent(tmp_path):
    # outside serve/fleet/obs of the port: its launchers print wall-clock
    # stamps; the JAX package's directories are the reference's scope
    for i, rel in enumerate(("src/repro_torch/launch/mod.py",
                             "src/repro/serve/mod.py")):
        assert run_rules(tmp_path / str(i), RPR401_BAD, "RPR401", rel) == []


def test_rpr402_fires(tmp_path):
    findings = both(tmp_path, RPR402_BAD, "RPR402",
                    "src/repro/obs/mod.py", "src/repro_torch/obs/mod.py")
    assert rule_ids(findings) == ["RPR402"]
    assert len(findings) == 2


def test_rpr402_clean_twin_silent(tmp_path):
    assert both(tmp_path, RPR402_CLEAN, "RPR402",
                "src/repro/obs/mod.py", "src/repro_torch/obs/mod.py") == []


# -- syntax errors ------------------------------------------------------------

def test_syntax_error_becomes_rpr000(tmp_path):
    place(tmp_path / "port", "def f(:\n", "broken.py")
    place(tmp_path / "ref", "def f(:\n", "broken.py")
    findings, n = analyze_paths([str(tmp_path / "port")],
                                root=str(tmp_path / "port"))
    ref, _ = ref_analysis.analyze_paths([str(tmp_path / "ref")],
                                        root=str(tmp_path / "ref"))
    assert n == 1
    assert rule_ids(findings) == ["RPR000"]
    assert keys(findings) == keys(ref)


# -- baseline workflow --------------------------------------------------------

def test_baseline_roundtrip_suppresses(tmp_path):
    (tmp_path / "bad.py").write_text(RPR301_BAD)
    findings, _ = analyze_paths([str(tmp_path)], root=str(tmp_path),
                                select=["RPR301"])
    assert findings
    bpath = str(tmp_path / "baseline.json")
    n = write_baseline(bpath, findings)
    assert n == 2
    bl = load_baseline(bpath)
    assert bl.entries == ref_baseline.load_baseline(bpath).entries
    kept, suppressed, stale = apply_baseline(findings, bl)
    assert kept == [] and len(suppressed) == 2 and stale == []


def test_baseline_stale_entries_reported(tmp_path):
    bpath = tmp_path / "baseline.json"
    bpath.write_text(json.dumps({
        "baseline_schema": 1,
        "entries": [{"rule": "RPT203", "file": "gone.py",
                     "context": "f", "reason": "was fixed"}]}))
    bl = load_baseline(str(bpath))
    kept, suppressed, stale = apply_baseline([], bl)
    assert stale == [("RPT203", "gone.py", "f")]


def test_baseline_empty_reason_rejected(tmp_path):
    bpath = tmp_path / "baseline.json"
    bpath.write_text(json.dumps({
        "baseline_schema": 1,
        "entries": [{"rule": "RPR301", "file": "x.py",
                     "context": "f", "reason": "  "}]}))
    with pytest.raises(BaselineError, match="empty reason"):
        load_baseline(str(bpath))


def test_baseline_bad_schema_rejected(tmp_path):
    bpath = tmp_path / "baseline.json"
    bpath.write_text(json.dumps({"baseline_schema": 99, "entries": []}))
    with pytest.raises(BaselineError, match="baseline_schema"):
        load_baseline(str(bpath))


def test_both_loaders_read_the_reference_baseline_alike():
    """The JAX package's committed baseline reads to the same entries in
    both loaders, and both split its findings identically."""
    path = str(REPO_ROOT / ".analysis-baseline.json")
    bl, ref_bl = load_baseline(path), ref_baseline.load_baseline(path)
    assert bl.entries == ref_bl.entries and len(bl.entries) == 3
    files = sorted({REPO_ROOT / e["file"] for e in bl.entries})
    findings, _ = ref_analysis.analyze_paths([str(f) for f in files],
                                             root=str(REPO_ROOT))
    split = apply_baseline(findings, bl)
    assert split == ref_baseline.apply_baseline(findings, ref_bl)
    kept, suppressed, stale = split
    assert len(suppressed) == 3 and stale == []


# -- CLI ----------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(RPR301_BAD)
    clean = tmp_path / "clean.py"
    clean.write_text(RPR301_CLEAN)

    assert cli_main([str(clean), "--no-baseline",
                     "--root", str(tmp_path)]) == 0
    assert cli_main([str(bad), "--no-baseline",
                     "--root", str(tmp_path)]) == 1
    assert cli_main([str(bad), "--select", "NOPE",
                     "--root", str(tmp_path)]) == 2

    mal = tmp_path / "mal.json"
    mal.write_text("{not json")
    assert cli_main([str(bad), "--baseline", str(mal),
                     "--root", str(tmp_path)]) == 2
    capsys.readouterr()


def test_cli_write_baseline_then_clean(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(RPR301_BAD)
    bpath = str(tmp_path / "bl.json")
    assert cli_main([str(bad), "--write-baseline", bpath,
                     "--root", str(tmp_path)]) == 0
    # TODO reasons are accepted (non-empty) and suppress the findings
    assert cli_main([str(bad), "--baseline", bpath,
                     "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "suppressed by baseline" in out


def test_cli_json_format(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(RPR301_BAD)
    assert cli_main([str(bad), "--no-baseline", "--format", "json",
                     "--root", str(tmp_path)]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["files"] == 1
    assert {f["rule"] for f in report["findings"]} == {"RPR301"}
    # the JAX package's report has the same keys
    assert ref_cli_main([str(bad), "--no-baseline", "--format", "json",
                         "--root", str(tmp_path)]) == 1
    assert json.loads(capsys.readouterr().out).keys() == report.keys()


def test_cli_default_baseline_is_the_ports(capsys):
    """With no --baseline the CLI reads .analysis-baseline-torch.json
    under --root: the port's gate passes, the RPR401 entry suppressing."""
    assert cli_main([*map(str, GATE_PATHS), "--root", str(REPO_ROOT)]) == 0
    assert "1 suppressed by baseline" in capsys.readouterr().out


def test_cli_module_entrypoint_without_torch_or_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c", BLOCKED_MAIN, "--list-rules"],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "RPT101" in r.stdout and "RPT207" in r.stdout \
        and "RPR303" in r.stdout and "RPR402" in r.stdout


def test_chip_smoke_analyzer_phase_on_the_cpu():
    """Phase 20 of chip_smoke.py needs no card: the gate in a subprocess
    with torch and jax blocked, and the launching wrappers equal to the
    counted ones."""
    sys.path.insert(0, str(REPO_ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO_ROOT))
    chip_smoke.analyzer_phase("CPU rehearsal")


# -- the port's gate ----------------------------------------------------------

def test_port_is_clean_under_its_baseline():
    """src/repro_torch, chip_smoke.py and chip_profile.py produce zero
    unsuppressed findings, and every committed baseline entry carries a
    real justification."""
    findings, n_files = analyze_paths([str(p) for p in GATE_PATHS],
                                      root=str(REPO_ROOT))
    assert n_files > 100
    bl = load_baseline(str(REPO_ROOT / ".analysis-baseline-torch.json"))
    for e in bl.entries:
        assert len(e["reason"]) > 20, f"flimsy justification: {e}"
        assert "TODO" not in e["reason"], f"unfilled justification: {e}"
    kept, suppressed, stale = apply_baseline(findings, bl)
    assert kept == [], "new findings:\n" + "\n".join(
        f.render() for f in kept)
    assert stale == [], f"stale baseline entries: {stale}"
    assert [(f.rule, f.file, f.context) for f in suppressed] == [
        ("RPR401", "src/repro_torch/fleet/manifest.py",
         "Manifest.reclaim_stale")]
