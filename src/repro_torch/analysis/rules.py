"""The port's invariant rules (RP001..RP009): the JAX package's codes, names
and scopes, reworded for ``repro_torch``.

========  ====================================================================
RP001     Dense GEMMs in ``models/`` must route through ``backend.matmul``
          — a direct ``@``/``torch.matmul``/``mm``/``bmm``/``addmm``/
          ``baddbmm``/``tensordot``/``F.linear`` or a weight ``einsum``
          silently runs ideal and skips the ``systolic_mac`` kernel and
          fault injection.
RP002     Only the pump thread may touch torch in ``server/`` — torch calls
          inside ``async def`` handlers run on the event loop and race the
          engine's device state or stall streaming.
RP003     Wall-clock reads in ``serve/``/``server/``/``hwloop/`` must go
          through the injectable ``clock=`` seam — direct ``time.*()`` calls
          break the virtual-time ``LoadHarness``.
RP004     No draws from hidden global random state — ``numpy.random``'s
          module functions, ``torch.manual_seed``/``torch.seed``, and
          ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
          ``bernoulli``/``multinomial`` without ``generator=``; seeded
          paths thread an explicit Generator.
RP005     No mutable default arguments.
RP006     Block/chunk sizes in ``kernels/`` come from ``kernels/tuning.py``
          or a kernel's ``launch_plan``/``pass_plan`` (a literal default
          bypasses them and breaks divisibility on off-plan shapes).  The
          JAX package's second half of this rule, literal ``BlockSpec``
          shapes, is Pallas-only and has no counterpart here.
RP007     No swallowed exceptions in ``serve/``/``server/``/``hwloop/`` —
          a bare ``except:`` or a pass-only ``except Exception:`` hides pump
          deaths and silent-corruption escalation.
RP008     No bare ``print()`` in ``serve``/``server``/``hwloop``/
          ``resilience``/``obs`` — runtime output flows through the
          ``repro_torch.obs`` event/metric path (or an explicit CLI sink);
          stray prints corrupt NDJSON trace streams piped to stdout.
RP009     Rail writes in ``railscale``/``serve`` go through
          ``GuardbandClamp`` — a direct ``set_rails``/
          ``set_partition_voltage`` call skips the envelope bound, dwell
          timer and max-step limit.
========  ====================================================================

Counterpart of ``repro.analysis.rules``: RP003, RP005, RP007, RP008 and
RP009 keep its logic word for word.  Rules are conservative by design: the
RP001 einsum check only fires when an operand is a subscript expression
(``p["w1"]`` — a parameter leaf), so activation-activation contractions
(attention scores, SSM scans) pass without annotation.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .findings import Finding

# ---- shared AST helpers -----------------------------------------------------


def build_import_table(tree: ast.AST) -> Dict[str, str]:
    """Map local alias -> canonical dotted origin.

    ``import torch.nn.functional as F`` -> {"F": "torch.nn.functional"}
    ``import time as _time``            -> {"_time": "time"}
    ``from time import perf_counter``   -> {"perf_counter": "time.perf_counter"}
    ``from torch import nn``            -> {"nn": "torch.nn"}
    """
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                table[local] = alias.name if alias.asname \
                    else alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for alias in node.names:
                if alias.name == "*":
                    continue
                table[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return table


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain as a dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def canonical(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Dotted name with its head resolved through the import table."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    origin = imports.get(head, head)
    return f"{origin}.{rest}" if rest else origin


@dataclass
class RuleContext:
    """Per-file state shared by every rule."""

    path: str                       # repo-relative, posix
    tree: ast.AST
    imports: Dict[str, str]
    lines: Sequence[str]            # raw source lines (0-based)
    segments: Tuple[str, ...] = ()  # path split on "/"

    def __post_init__(self) -> None:
        self.segments = tuple(self.path.split("/"))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


@dataclass(frozen=True)
class Rule:
    code: str
    name: str
    scopes: Tuple[str, ...]         # path segments; empty = everywhere
    fix_hint: str
    description: str
    check: Callable[[RuleContext], List[Finding]]

    def applies_to(self, ctx: RuleContext) -> bool:
        return not self.scopes or any(s in ctx.segments for s in self.scopes)


def _finding(rule: "Rule", ctx: RuleContext, node: ast.AST,
             message: str) -> Finding:
    line = getattr(node, "lineno", 1)
    return Finding(code=rule.code, path=ctx.path, line=line,
                   col=getattr(node, "col_offset", 0), message=message,
                   fix_hint=rule.fix_hint, line_text=ctx.line_text(line))


# ---- RP001: dense GEMM bypassing backend.matmul ----------------------------

_GEMM_CALLS = {
    "torch.matmul", "torch.mm", "torch.bmm", "torch.tensordot",
    "torch.addmm", "torch.baddbmm", "torch.nn.functional.linear",
    "numpy.dot", "numpy.matmul", "numpy.tensordot",
}
_EINSUM_CALLS = {"torch.einsum", "numpy.einsum"}


def _check_rp001(ctx: RuleContext) -> List[Finding]:
    rule = RP001
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            out.append(_finding(rule, ctx, node,
                                "matrix product via `@` bypasses the "
                                "backend router"))
        elif isinstance(node, ast.Call):
            name = canonical(node.func, ctx.imports)
            if name in _GEMM_CALLS:
                out.append(_finding(
                    rule, ctx, node,
                    f"direct `{name}` bypasses the backend router"))
            elif name in _EINSUM_CALLS:
                # weight GEMM heuristic: an operand that *is or contains* a
                # subscript (p["w1"]) is a parameter leaf — contraction
                # against it is a dense GEMM; activation einsums pass
                operands = node.args[1:] if node.args else []
                if any(isinstance(sub, ast.Subscript)
                       for arg in operands for sub in ast.walk(arg)):
                    out.append(_finding(
                        rule, ctx, node,
                        "einsum contracts a parameter leaf (subscripted "
                        "operand) outside the backend router"))
    return out


RP001 = Rule(
    code="RP001", name="gemm-bypasses-backend", scopes=("models",),
    fix_hint="route through repro_torch.backend.matmul (`from ..backend "
             "import matmul as bmm`) so non-ideal backends (the "
             "systolic_mac kernel, the emulated array) see this GEMM; "
             "ideal-only branches need `# lint: allow=RP001 <reason>`",
    description="dense GEMM in models/ bypassing backend.matmul",
    check=_check_rp001,
)


# ---- RP002: torch calls inside asyncio handlers ----------------------------


def _check_rp002(ctx: RuleContext) -> List[Finding]:
    rule = RP002
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = canonical(sub.func, ctx.imports)
                if name and (name == "torch" or name.startswith("torch.")):
                    out.append(_finding(
                        rule, ctx, sub,
                        f"`{name}` called inside async handler "
                        f"`{node.name}` — torch belongs to the pump thread"))
    return out


RP002 = Rule(
    code="RP002", name="torch-in-async-handler", scopes=("server",),
    fix_hint="hand work to the pump thread via its inbox (Request callbacks "
             "+ loop.call_soon_threadsafe); the event loop must only parse "
             "and stream",
    description="torch call reachable from an asyncio handler in server/",
    check=_check_rp002,
)


# ---- RP003: direct wall-clock reads ----------------------------------------

_CLOCK_CALLS = {"time.time", "time.monotonic", "time.perf_counter",
                "time.process_time"}


def _check_rp003(ctx: RuleContext) -> List[Finding]:
    rule = RP003
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = canonical(node.func, ctx.imports)
            if name in _CLOCK_CALLS:
                out.append(_finding(
                    rule, ctx, node,
                    f"direct `{name}()` read bypasses the injectable "
                    f"clock seam"))
    return out


RP003 = Rule(
    code="RP003", name="uninjected-wall-clock",
    scopes=("serve", "server", "hwloop"),
    fix_hint="accept `clock=time.monotonic` (a reference, not a call) as a "
             "parameter and read `self._clock()` so VirtualClock/LoadHarness "
             "can substitute virtual time",
    description="direct time.time/monotonic/perf_counter call in timed paths",
    check=_check_rp003,
)


# ---- RP004: draws from hidden global random state ---------------------------

_SEEDED_FACTORIES = {"default_rng", "Generator", "RandomState",
                     "SeedSequence", "PCG64", "Philox"}
#: torch calls that set or read the process-wide generator, always flagged
_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed",
                       "torch.random.manual_seed", "torch.random.seed",
                       "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
#: torch draws that take the process-wide generator unless given one
_TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint",
                "torch.randperm", "torch.normal", "torch.bernoulli",
                "torch.multinomial"}


def _check_rp004(ctx: RuleContext) -> List[Finding]:
    rule = RP004
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = canonical(node.func, ctx.imports)
        if not name:
            continue
        if name.startswith("numpy.random.") \
                and name.rsplit(".", 1)[1] not in _SEEDED_FACTORIES:
            out.append(_finding(
                rule, ctx, node,
                f"global `{name}()` draws from hidden process-wide state"))
        elif name in _TORCH_GLOBAL_SEEDS:
            out.append(_finding(
                rule, ctx, node,
                f"`{name}()` sets or reads torch's process-wide generator"))
        elif name in _TORCH_DRAWS and not any(
                kw.arg == "generator" for kw in node.keywords):
            out.append(_finding(
                rule, ctx, node,
                f"`{name}()` without `generator=` draws from torch's "
                f"process-wide generator"))
    return out


RP004 = Rule(
    code="RP004", name="unseeded-global-random", scopes=(),
    fix_hint="thread an explicit Generator through the call path "
             "(`np.random.default_rng(seed)`, or `torch.Generator(device)` "
             "seeded once and passed as `generator=`): harness/oracle runs "
             "must replay bit-exactly",
    description="draw from numpy's or torch's global random state",
    check=_check_rp004,
)


# ---- RP005: mutable default arguments --------------------------------------

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
_MUTABLE_CALLS = {"list", "dict", "set", "bytearray",
                  "collections.defaultdict", "collections.deque",
                  "collections.Counter", "collections.OrderedDict"}


def _is_mutable_default(node: ast.AST, imports: Dict[str, str]) -> bool:
    if isinstance(node, _MUTABLE_LITERALS):
        return True
    if isinstance(node, ast.Call):
        name = canonical(node.func, imports)
        return name in _MUTABLE_CALLS
    return False


def _check_rp005(ctx: RuleContext) -> List[Finding]:
    rule = RP005
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = node.args
        pos = list(a.posonlyargs) + list(a.args)
        for arg, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
            if _is_mutable_default(default, ctx.imports):
                out.append(_finding(
                    rule, ctx, default,
                    f"mutable default for `{arg.arg}` in `{node.name}` is "
                    f"shared across calls"))
        for arg, default in zip(a.kwonlyargs, a.kw_defaults):
            if default is not None and \
                    _is_mutable_default(default, ctx.imports):
                out.append(_finding(
                    rule, ctx, default,
                    f"mutable default for `{arg.arg}` in `{node.name}` is "
                    f"shared across calls"))
    return out


RP005 = Rule(
    code="RP005", name="mutable-default-arg", scopes=(),
    fix_hint="default to None and materialize inside the function body",
    description="mutable default argument",
    check=_check_rp005,
)


# ---- RP006: hard-coded kernel block/chunk sizes -----------------------------

_TUNED_PARAMS = {"block_m", "block_n", "block_k", "block", "chunk",
                 "chunk_q", "chunk_k"}


def _check_rp006(ctx: RuleContext) -> List[Finding]:
    rule = RP006
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = node.args
        pos = list(a.posonlyargs) + list(a.args)
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if arg.arg in _TUNED_PARAMS and \
                    isinstance(default, ast.Constant) and \
                    isinstance(default.value, int) and \
                    not isinstance(default.value, bool):
                out.append(_finding(
                    rule, ctx, default,
                    f"`{node.name}` pins `{arg.arg}={default.value}` — "
                    f"a literal default bypasses the tuning tables and "
                    f"breaks divisibility on off-table shapes"))
    return out


RP006 = Rule(
    code="RP006", name="hardcoded-kernel-blocks", scopes=("kernels",),
    fix_hint="default block/chunk params to None and resolve them via "
             "kernels/tuning.py (select_blocks/select_chunk) or the "
             "kernel's launch_plan/pass_plan, then assert divisibility with "
             "tuning.assert_divides",
    description="literal block/chunk default in kernels/ bypassing the "
                "tuning tables and launch plans (the JAX package's "
                "BlockSpec half is Pallas-only and dropped)",
    check=_check_rp006,
)


# ---- RP007: swallowed exceptions in the serving/hardware path ---------------

_BROAD_EXC = {"Exception", "BaseException"}


def _swallows(body: Sequence[ast.stmt]) -> bool:
    """A handler body that only `pass`es (or `...`s) discards the fault."""
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Constant) and \
                stmt.value.value is Ellipsis:
            continue
        return False
    return True


def _check_rp007(ctx: RuleContext) -> List[Finding]:
    rule = RP007
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            out.append(_finding(
                rule, ctx, node,
                "bare `except:` catches everything (KeyboardInterrupt, "
                "SystemExit, pump shutdown) — faults vanish silently"))
            continue
        types = node.type.elts if isinstance(node.type, ast.Tuple) \
            else [node.type]
        broad = [canonical(t, ctx.imports) for t in types
                 if canonical(t, ctx.imports) in _BROAD_EXC]
        if broad and _swallows(node.body):
            out.append(_finding(
                rule, ctx, node,
                f"`except {', '.join(broad)}` with a pass-only body "
                f"swallows the fault instead of surfacing or handling it"))
    return out


RP007 = Rule(
    code="RP007", name="swallowed-exception",
    scopes=("serve", "server", "hwloop"),
    fix_hint="catch the narrowest exception type the contract allows "
             "(narrow-typed `except ...: pass` is fine), or handle the "
             "fault and surface it through telemetry/re-raise; intentional "
             "broad catches need `# lint: allow=RP007 <reason>`",
    description="bare or pass-only broad except in serve/server/hwloop",
    check=_check_rp007,
)


def _check_rp008(ctx: RuleContext) -> List[Finding]:
    rule = RP008
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "print":
            out.append(_finding(
                rule, ctx, node,
                "bare `print()` bypasses the obs event/metric path — it is "
                "invisible to the flight recorder and corrupts NDJSON trace "
                "streams on stdout"))
    return out


RP008 = Rule(
    code="RP008", name="bare-print",
    scopes=("serve", "server", "hwloop", "resilience", "obs"),
    fix_hint="emit through `obs.event(...)`/a registry metric, or return the "
             "payload to the CLI layer (`repro_torch.launch`) which owns stdout; "
             "intentional CLI prints need `# lint: allow=RP008 <reason>`",
    description="bare print() in serve/server/hwloop/resilience/obs",
    check=_check_rp008,
)


# ---- RP009: rail writes bypassing the guardband clamp ----------------------

_RAIL_SETTERS = {"set_rails", "set_partition_voltage"}


def _check_rp009(ctx: RuleContext) -> List[Finding]:
    rule = RP009
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _RAIL_SETTERS:
            out.append(_finding(
                rule, ctx, node,
                f"direct `.{node.func.attr}()` skips the guardband clamp "
                f"(envelope bound, dwell timer, max step) — the autoscaler "
                f"and watchdog can end up fighting over the rails"))
    return out


RP009 = Rule(
    code="RP009", name="unclamped-rail-write",
    scopes=("railscale", "serve"),
    fix_hint="actuate through repro_torch.railscale.GuardbandClamp "
             "(`clamp.apply(session, target_v, step)` / `clamp.snap`) so "
             "every rail write is envelope-bounded, dwell-limited, and "
             "step-limited; the clamp's own writes carry "
             "`# lint: allow=RP009 <reason>`",
    description="direct set_rails/set_partition_voltage in railscale/serve",
    check=_check_rp009,
)


RULES: Tuple[Rule, ...] = (RP001, RP002, RP003, RP004, RP005, RP006, RP007,
                           RP008, RP009)


def rule_codes() -> List[str]:
    return [r.code for r in RULES]
