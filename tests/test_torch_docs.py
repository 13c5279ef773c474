"""The port's API page and docstring gate (``repro_torch.docs``) against
the JAX package's (``repro.docs``): the same rules of what counts as
documented and the same rendering, over the port's own ``PUBLIC_API``;
every listed name imports from ``repro_torch`` and has a docstring, the
committed ``docs/api_torch.md`` is the page ``render_api_md`` gives, and
``python -m repro_torch.docs --check`` exits 0 (non-zero on a missing
docstring).  ``docs/api.md`` stays the reference's page."""

import inspect
import os
import pathlib
import subprocess
import sys

import pytest

from repro import docs as jdocs
from repro_torch import docs as tdocs
from repro_torch.docs import __main__ as tmain

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_every_public_name_imports_from_the_port_and_is_documented():
    entries = list(tdocs.iter_api())
    assert len(entries) == sum(len(n) for _, n in tdocs.PUBLIC_API)
    for mod_name, name, obj in entries:
        assert mod_name.startswith("repro_torch"), mod_name
        module = getattr(obj, "__module__", mod_name) or mod_name
        assert not module.startswith("repro."), (mod_name, name, module)
        assert inspect.getdoc(obj), f"{mod_name}.{name}"
    assert tdocs.missing_docstrings() == []
    names = {f"{m}.{n}" for m, n, _ in entries}
    for want in ("repro_torch.core.partition_torch.build_eval_tables",
                 "repro_torch.core.nsga2_torch.torch_nsga2",
                 "repro_torch.explore.TorchNSGA2Search",
                 "repro_torch.kernels.ops.window_attn",
                 "repro_torch.serve.PipelineServeEngine",
                 "repro_torch.obs.Tracer",
                 "repro_torch.models.registry.build_model",
                 "repro_torch.training.make_train_step",
                 "repro_torch.optim.adamw"):
        assert want in names, want


def test_api_torch_md_is_the_rendered_page():
    """Regenerate with ``PYTHONPATH=src python -m repro_torch.docs``."""
    on_disk = (ROOT / "docs" / "api_torch.md").read_text()
    assert on_disk == tdocs.render_api_md()
    assert (ROOT / "docs" / "api.md").read_text() == jdocs.render_api_md()


def test_rules_are_the_reference_rules(monkeypatch):
    """One class with an undocumented method and one undocumented function,
    listed in both packages: both report the same two paths, and render the
    same blocks for them."""
    mod = type(sys)("docs_probe")

    class Probe:
        """A documented class."""

        def shown(self):
            """A documented method."""

        def hidden(self):
            pass

        @property
        def size(self):
            return 1

    def bare(x, y=2):
        return x

    mod.Probe, mod.bare = Probe, bare
    monkeypatch.setitem(sys.modules, "docs_probe", mod)
    api = (("docs_probe", ("Probe", "bare")),)
    monkeypatch.setattr(jdocs, "PUBLIC_API", api)
    monkeypatch.setattr(tdocs, "PUBLIC_API", api)
    want = ["docs_probe.Probe.hidden", "docs_probe.Probe.size",
            "docs_probe.bare"]
    assert tdocs.missing_docstrings() == jdocs.missing_docstrings() == want
    body = tdocs.render_api_md().split("## `docs_probe`")[1]
    assert body == jdocs.render_api_md().split("## `docs_probe`")[1]
    monkeypatch.setattr(tdocs, "PUBLIC_API",
                        (("docs_probe", ("Probe", "missing")),))
    with pytest.raises(AttributeError, match="missing"):
        tdocs.missing_docstrings()


def test_check_exits_zero_and_fails_on_a_missing_docstring(monkeypatch,
                                                           capsys,
                                                           tmp_path):
    assert tmain.main(["--check"]) == 0
    assert "docstring coverage: ok" in capsys.readouterr().out
    out = tmp_path / "api.md"
    assert tmain.main(["--out", str(out)]) == 0
    assert out.read_text() == tdocs.render_api_md()
    monkeypatch.setattr(tmain, "missing_docstrings",
                        lambda: ["repro_torch.x.y"])
    assert tmain.main(["--check"]) == 1
    assert "repro_torch.x.y" in capsys.readouterr().err


def test_module_entry_point_checks():
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.docs", "--check"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "docstring coverage: ok" in done.stdout
