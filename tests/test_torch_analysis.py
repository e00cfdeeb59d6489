"""The port's static lint (repro_torch.analysis.lint and rules) on
snippets, against the JAX package's where their rules are the same, and
over the port itself.

The port's RPR001 reads torch's host transfers (``.cpu()``, ``.numpy()``,
``.to("cpu")``, ``bool()``/``int()`` and truth tests on a tensor
expression) beside the reference's, and its RPR003 reads ``torch`` in a
gauge path; the reference's lint passes all of these (the scratch cases of
ROADMAP's F2, held below). RPR002 and RPR005 are not ported: an allow
naming them is an unknown rule. Suppression, RPR004 and RPR006 give the
reference's findings on the same sources.
"""
import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.rules import RULES

# Markers are assembled so that they do not appear literally in this
# file's lines, which the lint reads too.
_HOT = "# repro: " + "hot-path\n"
_GAUGE = "# repro: " + "gauge-path\n"
_ALLOW = "# repro: " + "allow"

# F2's scratch cases: each a hot-path or gauge-path snippet that the JAX
# package's lint passes and the port's must flag, with the lines it flags.
F2_CASES = {
    "cpu_numpy": (_HOT + "import torch\nx = torch.zeros(3)\n"
                  "a = x.cpu().numpy()\n", [4, 4]),
    "bool": (_HOT + "import torch\nt = torch.ones(2)\nb = bool(t)\n", [4]),
    "to_cpu": (_HOT + "import torch\nt = torch.ones(2)\nc = t.to('cpu')\n",
               [4]),
    "to_device_cpu": (_HOT + "import torch\nt = torch.ones(2)\n"
                      "c = t.to(device=torch.device('cpu'))\n", [4]),
    "int_of_reduction": (_HOT + "import torch\nt = torch.ones(2)\n"
                         "n = int(t.sum())\n", [4]),
    "truth_test": (_HOT + "import torch\nt = torch.ones(2)\n"
                   "if (t > 0).any():\n    pass\nok = not t\n", [4, 6]),
    "annotated_argument": (_HOT + "import torch\n"
                           "def f(u: torch.Tensor):\n"
                           "    w = u * 2\n"
                           "    return bool(w)\n", [5]),
    "gauge_import_torch": (_GAUGE + "import torch\ny = torch.zeros(1)\n",
                           [2, 3]),
    "gauge_from_torch": (_GAUGE + "from torch import cuda\n", [2]),
}


def _rules(findings):
    return [f.rule for f in findings]


def _lines(findings):
    return [f.line for f in findings]


@pytest.mark.parametrize("case", sorted(F2_CASES))
def test_f2_scratch_cases_are_flagged(case):
    src, lines = F2_CASES[case]
    found = tlint.lint_file("snippet.py", src)
    want = "RPR003" if src.startswith(_GAUGE) else "RPR001"
    assert _rules(found) == [want] * len(lines)
    assert _lines(found) == lines
    # the reference's lint passes it: the gap F2 names
    assert jlint.lint_file("snippet.py", src) == []


def test_rpr001_reference_sites_still_fire():
    src = _HOT + "f = float(result)\na = np.asarray(x)\nv = x.item()\n" \
        "w = x.tolist()\n"
    assert _rules(tlint.lint_file("hot.py", src)) == ["RPR001"] * 4
    assert _rules(tlint.lint_file("plain.py", src[len(_HOT):])) == []


def test_rpr001_leaves_host_numbers_alone():
    src = (_HOT
           + "import numpy as np\nimport torch\n"
           + "a = float('1.5')\n"                # a literal
           + "b = int(n)\n"                      # host plan arithmetic
           + "c = np.array([1, 2])\n"
           + "d = int(np.fromiter(it, np.int64).max())\n"
           + "t = torch.zeros(4)\n"
           + "e = int(t.shape[0]) + int(t.numel())\n"   # host metadata
           + "if t.is_cuda and n:\n    pass\n"
           + "def f(t, pages):\n"                # parameters shadow t
           + "    if t:\n        return bool(pages)\n")
    assert tlint.lint_file("hot.py", src) == []


def test_rpr003_port_gauge_path_stays_stdlib():
    assert tlint.lint_file("obs.py", _GAUGE + "import time\nimport json\n") \
        == []
    src = _GAUGE + "import jax\ny = jnp.sum(x)\n"      # jax too
    assert _rules(tlint.lint_file("obs.py", src)) == ["RPR003"] * 2


def test_unported_rules_are_unknown():
    assert set(RULES) == {"RPR001", "RPR003", "RPR004", "RPR006"}
    assert tlint.lint_file("core.py", "out = _block_step(x, aggs)\n") == []
    assert tlint.lint_file("src/x/engine/e.py", "fn = jax.jit(run)\n") == []
    for rule in ("RPR002", "RPR005"):
        found = tlint.lint_file("a.py", f"x = 1  {_ALLOW}[{rule}] reason\n")
        assert _rules(found) == ["RPR006"]
        assert "unknown rule" in found[0].message


# Sources on which the two packages' rules are the same: suppression
# mechanics, RPR004 and RPR006; each must give the reference's findings
# (as many as listed).
SHARED = {
    "allow_with_reason": (
        _HOT + f"f = float(r)  {_ALLOW}[RPR001] end sync\n", 0),
    "bare_allow": (_HOT + f"f = float(r)  {_ALLOW}[RPR001]\n", 2),
    "unknown_rule": (f"x = 1  {_ALLOW}[RPR999] because reasons\n", 1),
    "comment_line_allow": (_HOT + f"{_ALLOW}[RPR001] the sync point\n"
                           "# (continuation)\nf = float(r)\n", 0),
    "def_line_allow": (_HOT + f"{_ALLOW}[RPR001] cold path\n"
                       "def restore(x):\n    a = float(x)\n"
                       "    return np.asarray(a)\nf = float(other)\n", 1),
    "wall_clock": ("@jax.jit\ndef f(x):\n    t = time.time()\n"
                   "    return x + t\nwith tracer.span('step'):\n"
                   "    t1 = time.time()\nt0 = time.time()\n", 2),
    "syntax_error": ("def f(:\n", 1),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rules_match_the_reference(case):
    src, n = SHARED[case]
    got = [(f.line, f.col, f.rule) for f in tlint.lint_file("m.py", src)]
    want = [(f.line, f.col, f.rule) for f in jlint.lint_file("m.py", src)]
    assert got == want and len(got) == n


def test_the_port_is_lint_clean(capsys):
    assert tlint.lint_paths(["src/repro_torch"]) == []
    assert tlint.main(["src/repro_torch"]) == 0
    assert tlint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out


def test_each_hot_path_sync_of_the_port_is_a_declared_one():
    """Without their allows, the port's hot-path files show each designed
    sync: the harvest read-back, the solve's end-of-run reads and the
    bounds taken as host numbers."""
    from pathlib import Path
    root = Path("src/repro_torch")
    seen = {}
    for rel in ("core/abo.py", "engine/scheduler.py", "engine/batched.py"):
        src = (root / rel).read_text().replace(_ALLOW + "[RPR001]",
                                               "# allow removed")
        seen[rel] = _rules(tlint.lint_file(rel, src))
    assert seen["engine/batched.py"] == []
    assert seen["core/abo.py"] and set(seen["core/abo.py"]) == {"RPR001"}
    assert seen["engine/scheduler.py"] and \
        set(seen["engine/scheduler.py"]) == {"RPR001"}


@pytest.mark.parametrize("rel", ["models/rwkv6.py",
                                 "kernels/rwkv6_wkv/ops.py",
                                 "kernels/rwkv6_wkv/ref.py"])
def test_rwkv6_prefill_path_has_no_host_sync(rel):
    """RWKV6's time mix and W's wrapper are hot paths with no designed
    sync: RPR001 reads them and finds nothing, with no allow to hide one."""
    from pathlib import Path
    src = (Path("src/repro_torch") / rel).read_text()
    assert _ALLOW not in src
    assert tlint.lint_file(rel, _HOT + src) == []
