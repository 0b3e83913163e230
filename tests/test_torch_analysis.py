"""The port's invariant linter (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): per-rule fixtures in torch form (each trips
its rule exactly once), suppression syntax, scoping, the baseline round
trip, the registry, RP007's variants, the torch forms of the reworded
rules, parity of the unchanged rules on both fixture trees, and the
dogfood gate on ``src/repro_torch``."""

from pathlib import Path

import pytest

from repro.analysis import checker as ref_checker
from repro.analysis import rules as ref_rules
from repro_torch.analysis import (RULES, Finding, lint_file, lint_paths,
                                  load_baseline, rule_codes, write_baseline)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.checker import lint_source
from repro_torch.analysis.findings import apply_baseline

FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
REF_FIXTURES = Path(__file__).parent / "analysis" / "fixtures"
REPO_ROOT = Path(__file__).resolve().parents[1]

CASES = [
    ("models/tp001_matmul.py", "RP001"),
    ("server/tp002_async.py", "RP002"),
    ("serve/tp003_clock.py", "RP003"),
    ("hwloop/tp004_random.py", "RP004"),
    ("common/tp005_mutable.py", "RP005"),
    ("kernels/tp006_blocks.py", "RP006"),
    ("serve/tp007_except.py", "RP007"),
    ("obs/tp008_print.py", "RP008"),
    ("railscale/tp009_rails.py", "RP009"),
]
#: the rules whose logic is the JAX package's word for word
UNCHANGED = ("RP003", "RP005", "RP007", "RP008", "RP009")


@pytest.mark.parametrize("rel,code", CASES, ids=[c for _, c in CASES])
def test_fixture_trips_rule_exactly_once(rel, code):
    findings = lint_file(FIXTURES / rel, root=FIXTURES)
    assert [f.code for f in findings] == [code], findings
    f = findings[0]
    assert f.path == rel
    assert f.fix_hint                      # every rule ships a fix-hint
    assert f.line_text                     # baseline key is the source text


def test_fixture_basenames_differ_from_the_reference_fixtures():
    ours = {p.name for p in FIXTURES.rglob("*.py")}
    theirs = {p.name for p in REF_FIXTURES.rglob("*.py")}
    assert len(ours) == len(CASES) + 2 and not ours & theirs


def test_clean_fixtures_stay_clean():
    for rel in ("models/tp001_einsum_clean.py", "models/tp_suppressed.py"):
        assert lint_file(FIXTURES / rel, root=FIXTURES) == []


def test_inline_suppression_marker_on_line_above():
    src = (
        "import torch\n"
        "def f(x, p):\n"
        "    # lint: allow=RP001 reason lives here\n"
        "    return torch.mm(x, p)\n"
    )
    assert lint_source(src, "models/x.py") == []
    # without the marker the same source trips
    assert [f.code for f in
            lint_source(src.replace("# lint: allow=RP001 reason lives here",
                                    "pass"), "models/x.py")] == ["RP001"]


def test_rule_scoping_by_path_segment():
    src = "import torch\ndef f(x, p):\n    return torch.mm(x, p)\n"
    assert [f.code for f in lint_source(src, "models/a.py")] == ["RP001"]
    assert lint_source(src, "serve/a.py") == []   # RP001 scoped to models/
    assert lint_source(src, "src/repro_torch/modelsx/a.py") == []


def test_baseline_roundtrip(tmp_path):
    all_findings = []
    for rel, _ in CASES:
        all_findings += lint_file(FIXTURES / rel, root=FIXTURES)
    baseline = tmp_path / "baseline.json"
    write_baseline(all_findings, baseline)

    loaded = load_baseline(baseline)
    assert sum(loaded.values()) == len(all_findings)

    fresh, absorbed = lint_paths(
        [FIXTURES / rel for rel, _ in CASES], root=FIXTURES,
        baseline_path=baseline)
    assert fresh == [] and absorbed == len(all_findings)

    # a brand-new violation is NOT absorbed
    extra = lint_source(
        "import torch\ndef g(a, b):\n    return torch.bmm(a, b)\n",
        "models/new.py")
    assert [f.code for f in extra] == ["RP001"]
    assert load_baseline(baseline)[extra[0].key()] == 0


def test_baseline_counts_duplicates(tmp_path):
    f = Finding("RP001", "models/x.py", 3, 0, "m", "h", "y = torch.mm(a, b)")
    twin = Finding("RP001", "models/x.py", 9, 0, "m", "h",
                   "y = torch.mm(a, b)")
    baseline = tmp_path / "b.json"
    write_baseline([f], baseline)
    # same source text twice, only one budgeted -> second stays fresh
    assert apply_baseline([f, twin], load_baseline(baseline)) == [twin]


def test_rule_registry_complete():
    assert rule_codes() == [f"RP00{i}" for i in range(1, 10)]
    assert all(r.fix_hint and r.description for r in RULES)
    # the JAX package's codes, names (RP002 and RP006 renamed for torch)
    # and scopes
    for mine, theirs in zip(RULES, ref_rules.RULES):
        assert (mine.code, mine.scopes) == (theirs.code, theirs.scopes)
        if mine.code not in ("RP002", "RP006"):
            assert mine.name == theirs.name
    assert "repro_torch.backend.matmul" in RULES[0].fix_hint
    assert "Pallas" in RULES[5].description       # the BlockSpec half dropped


def test_rp007_variants():
    # bare except is flagged regardless of what the body does
    bare = ("def f(q):\n"
            "    try:\n"
            "        return q.pop()\n"
            "    except:\n"
            "        return None\n")
    assert [f.code for f in lint_source(bare, "server/x.py")] == ["RP007"]
    # narrow-typed pass is the sanctioned client-went-away idiom
    narrow = ("def f(w):\n"
              "    try:\n"
              "        w.close()\n"
              "    except (ConnectionResetError, BrokenPipeError):\n"
              "        pass\n")
    assert lint_source(narrow, "server/x.py") == []
    # a broad except that HANDLES the fault (surfaces it) is fine
    handled = ("def f(q, log):\n"
               "    try:\n"
               "        return q.pop()\n"
               "    except Exception as e:\n"
               "        log.append(e)\n"
               "        raise\n")
    assert lint_source(handled, "serve/x.py") == []
    # ...but a pass-only broad except swallows it
    swallowed = ("def f(q):\n"
                 "    try:\n"
                 "        return q.pop()\n"
                 "    except BaseException:\n"
                 "        ...\n")
    assert [f.code for f in lint_source(swallowed, "hwloop/x.py")] == \
        ["RP007"]
    # out of scope: the rule only polices the serving/hardware path
    assert lint_source(swallowed, "models/x.py") == []


RP001_FORMS = [
    ("x @ w", True),
    ("torch.matmul(x, w)", True),
    ("torch.mm(x, w)", True),
    ("torch.bmm(x, w)", True),
    ("torch.tensordot(x, w, dims=1)", True),
    ("torch.addmm(b, x, w)", True),
    ("torch.baddbmm(b, x, w)", True),
    ("F.linear(x, w)", True),
    ("torch.nn.functional.linear(x, w)", True),
    ("np.dot(x, w)", True),
    ("np.einsum('td,df->tf', x, p['w'])", True),
    ("torch.einsum('td,df->tf', x, p['w'])", True),
    ("torch.einsum('bqd,bkd->bqk', q, k)", False),
    ("torch.mul(x, w)", False),
    ("x.sum(-1)", False),
]


@pytest.mark.parametrize("expr,flagged", RP001_FORMS,
                         ids=[e for e, _ in RP001_FORMS])
def test_rp001_torch_forms(expr, flagged):
    src = ("import numpy as np\nimport torch\n"
           "import torch.nn.functional as F\n"
           f"def f(x, w, b, p, q, k):\n    return {expr}\n")
    codes = [f.code for f in lint_source(src, "models/x.py")]
    assert codes == (["RP001"] if flagged else [])


RP004_FORMS = [
    ("torch.manual_seed(0)", True),
    ("torch.seed()", True),
    ("torch.cuda.manual_seed_all(0)", True),
    ("torch.rand(3)", True),
    ("torch.randn(3, 4)", True),
    ("torch.randint(0, 9, (3,))", True),
    ("torch.randperm(5)", True),
    ("torch.normal(m, s)", True),
    ("torch.bernoulli(m)", True),
    ("torch.multinomial(m, 2)", True),
    ("np.random.rand(3)", True),
    ("torch.randn(3, generator=g)", False),
    ("torch.randint(0, 9, (3,), generator=g, device='cpu')", False),
    ("torch.multinomial(m, 2, generator=g)", False),
    ("g.manual_seed(0)", False),
    ("np.random.default_rng(0).normal()", False),
]


@pytest.mark.parametrize("expr,flagged", RP004_FORMS,
                         ids=[e for e, _ in RP004_FORMS])
def test_rp004_torch_forms(expr, flagged):
    src = ("import numpy as np\nimport torch\n"
           f"def f(g, m, s):\n    return {expr}\n")
    codes = [f.code for f in lint_source(src, "serve/x.py")]
    assert codes == (["RP004"] if flagged else [])


def test_rp002_flags_torch_not_jax_and_rp006_no_blockspec():
    src = ("import torch\nimport jax.numpy as jnp\n"
           "async def h(x):\n    y = jnp.asarray(x)\n"
           "    return torch.zeros(3)\n")
    got = lint_source(src, "server/x.py")
    assert [(f.code, f.line) for f in got] == [("RP002", 5)]
    assert "pump thread" in got[0].message
    spec = ("from jax.experimental import pallas as pl\n"
            "def k(x):\n    return pl.BlockSpec((128, 128), lambda i: i)\n")
    assert lint_source(spec, "kernels/x.py") == []
    assert [f.code for f in ref_checker.lint_source(spec, "kernels/x.py")] \
        == ["RP006"]


def _fields(f):
    return (f.code, f.path, f.line, f.col, f.message, f.line_text)


@pytest.mark.parametrize("tree", [REF_FIXTURES, FIXTURES],
                         ids=["reference_fixtures", "port_fixtures"])
def test_unchanged_rules_match_the_reference_linter(tree):
    mine = [r for r in RULES if r.code in UNCHANGED]
    theirs = [r for r in ref_rules.RULES if r.code in UNCHANGED]
    files = sorted(tree.rglob("*.py"))
    assert files
    seen = 0
    for path in files:
        rel = path.relative_to(tree).as_posix()
        src = path.read_text()
        got = lint_source(src, rel, mine)
        want = ref_checker.lint_source(src, rel, theirs)
        assert [_fields(f) for f in got] == [_fields(f) for f in want], rel
        seen += len(got)
    assert seen >= 5          # every unchanged rule trips on some fixture


def test_cli_lint_exit_codes(capsys, tmp_path):
    assert cli.main(["lint"]) == 0
    assert capsys.readouterr().out.strip().endswith("clean")
    assert cli.main(["lint", str(FIXTURES)]) == 1
    out = capsys.readouterr().out
    assert f"{len(CASES)} finding(s)" in out
    baseline = tmp_path / "b.json"
    assert cli.main(["lint", str(FIXTURES), "--baseline", str(baseline),
                     "--write-baseline"]) == 0
    assert cli.main(["lint", str(FIXTURES), "--baseline",
                     str(baseline)]) == 0
    assert f"({len(CASES)} baselined)" in capsys.readouterr().out
    assert cli.main(["rules"]) == 0
    assert "RP009" in capsys.readouterr().out


def test_repo_port_is_clean_under_checked_in_baseline():
    """The dogfood gate: src/repro_torch must lint clean with the port's
    baseline (intentional exemptions are inline-suppressed, not
    baselined), and that baseline is empty."""
    baseline = REPO_ROOT / "lint_baseline_torch.json"
    assert sum(load_baseline(baseline).values()) == 0
    fresh, absorbed = lint_paths([REPO_ROOT / "src" / "repro_torch"],
                                 root=REPO_ROOT, baseline_path=baseline)
    assert fresh == [] and absorbed == 0, \
        "\n".join(f.format() for f in fresh)
