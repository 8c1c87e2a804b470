"""Lints of the port: host syncs on the step path, f32 comm
accumulators, thread discipline.

Port of ``repro/analysis/lint.py``, over ``src/repro_torch``, stdlib
``ast`` only (this module imports no torch, so the lint lane runs
anywhere).  Three rule families:

``host-sync``
    The reference's ``tracer-hazard`` rule, for an eager port: the roots
    are the per-step functions (:data:`HOST_SYNC_ROOTS`: the programs
    ``serving/engine.py`` builds, the decode and prefill steps of
    ``serving/batching.py`` and ``serving/speculative.py``, the chunk
    functions of ``train/engine.py``, the optimizer's step and the mixing
    apply; a module may name its own in a module-level
    ``HOST_SYNC_ROOTS = (...)`` tuple of qualnames).  In every function
    reached from a root by name (across the linted tree), it flags what
    makes the host wait for the card: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``, ``int()`` /
    ``float()`` / ``bool()`` over anything but static metadata
    (``.shape``, ``.ndim``, ``.size``, ``.numel()``, ``.dim()``,
    ``len(...)`` are exempt, as in the reference), ``if`` / ``while`` on
    a tensor reduction (``.any()``, ``.all()``, ``torch.equal``, ...),
    ``torch.tensor(<host value>, device=...)`` and ``.to(<device>)``, the
    pageable host-to-device copies, and ``t[i] = <host scalar>`` (a
    number, or a parameter annotated ``int`` / ``float`` / ``bool``),
    which copies the scalar to the card as a tensor.  A flagged call is a sync only when
    its operand lives on the card; the checked baseline says, for each
    one the port keeps, why it stays.

``f32-accumulator``
    Assignments to comm/metrics accounting names (``*comm*``,
    ``*_total``, ``*_bytes``) from expressions that mention a narrow
    float dtype: the accounting must stay exact float64.

``thread-discipline``
    For classes that spawn threads, every attribute written by code the
    thread target can reach must be lock-guarded at every access in the
    class (the reference's rule, unchanged).

Violations carry a stable ``key`` (rule:path:function:detail, no line
numbers).  ``load_baseline`` / ``apply_baseline`` implement the checked
suppression workflow: a baseline entry that matches no violation is
itself an error.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Violation",
    "lint_source",
    "lint_file",
    "lint_tree",
    "load_baseline",
    "apply_baseline",
    "RULES",
    "HOST_SYNC_ROOTS",
]

RULES = ("host-sync", "f32-accumulator", "thread-discipline")

#: the per-step functions of the port, by path under ``repro_torch`` and
#: qualname (nested functions joined by ".")
HOST_SYNC_ROOTS: Dict[str, Tuple[str, ...]] = {
    "serving/engine.py": ("_build_prefill.program", "_build_decode.program",
                          "_build_staged.prefill", "_build_staged.decode"),
    "serving/batching.py": ("ContinuousServer._chunk_program",
                            "ContinuousServer._admit_program",
                            "ContinuousServer._decode_program",
                            "ContinuousServer._spec_program"),
    "serving/speculative.py": ("speculative_step",),
    "train/engine.py": ("make_fused_chunk_fn.chunk_fn",
                        "make_pipelined_chunk_fn.chunk_fn"),
    "optim/optimizers.py": ("sgd_update", "adamw_update"),
    "core/mixing.py": ("mix_once", "mix_collective_blocked"),
    "core/shardplan.py": ("mix_collective_sharded",),
}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # repo-relative (or as given)
    line: int
    func: str  # enclosing function qualname, or "<module>"
    detail: str  # stable discriminator (e.g. "float()", "attr:_pending")
    message: str

    @property
    def key(self) -> str:
        """Baseline key: deliberately line-number free."""
        return f"{self.rule}:{self.path}:{self.func}:{self.detail}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _last_seg(func: ast.expr) -> Optional[str]:
    """Final name segment of a call target: jax.lax.scan -> "scan"."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _root_name(node: ast.expr) -> Optional[str]:
    """Root of an attribute/subscript/call chain: np.iinfo(x).max -> "np"."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


class _Parented(ast.NodeVisitor):
    def __init__(self) -> None:
        self.parents: Dict[ast.AST, ast.AST] = {}

    def generic_visit(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            self.parents[child] = node
        super().generic_visit(node)


def _qualname(node: ast.AST, parents: Dict[ast.AST, ast.AST]) -> str:
    parts: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            parts.append(cur.name)
        elif isinstance(cur, ast.Lambda):
            parts.append("<lambda>")
        elif isinstance(cur, ast.ClassDef):
            parts.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(parts)) or "<module>"


# ---------------------------------------------------------------------------
# rule 1: host syncs on the step path
# ---------------------------------------------------------------------------

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "device"}
_STATIC_CALLS = {"len", "numel", "dim", "element_size", "size"}
_REDUCTIONS = {"any", "all", "equal", "allclose", "isfinite", "isnan",
               "isinf", "nonzero", "count_nonzero"}


def _is_static_metadata(expr: ast.expr) -> bool:
    """True when ``int()``/``float()``/``bool()`` over this expression
    reads no tensor value: a constant, or shape/rank metadata."""
    if isinstance(expr, ast.Constant):
        return True
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return True
        if isinstance(node, ast.Call) and _last_seg(node.func) in \
                _STATIC_CALLS:
            return True
    return False


def _tensor_test(test: ast.expr) -> bool:
    """An ``if`` / ``while`` test that reduces a tensor to a truth value."""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr in _REDUCTIONS for n in ast.walk(test))


def _device_arg(call: ast.Call) -> bool:
    """``.to(...)`` with a device: a ``device=`` keyword, or a positional
    name / attribute that says device (``dev``, ``device``,
    ``self.device``, ``x.device``)."""
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    for a in call.args:
        seg = _last_seg(a) if isinstance(a, (ast.Name, ast.Attribute)) \
            else None
        if seg is not None and ("device" in seg or seg == "dev"):
            return True
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and \
                a.value.startswith("cuda"):
            return True
    return False


def _host_scalars(fn: ast.AST) -> Set[str]:
    """``fn``'s parameters annotated as host scalars (int, float, bool)."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if isinstance(x.annotation, ast.Name)
            and x.annotation.id in ("int", "float", "bool")}


def _sync_of(node: ast.AST, fn: ast.AST) -> Optional[Tuple[str, str]]:
    """(detail, message) when ``node`` (in function ``fn``) can make the
    host wait for the card, else None."""
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Subscript)
            and ((isinstance(node.value, ast.Constant)
                  and isinstance(node.value.value, (int, float)))
                 or (isinstance(node.value, ast.Name)
                     and node.value.id in _host_scalars(fn)))):
        return ("setitem-scalar", "a host scalar stored into a tensor by "
                "index is copied to the card as a tensor (a sync when the "
                "tensor lives on the card)")
    if isinstance(node, (ast.If, ast.While)) and _tensor_test(node.test):
        kw = "if" if isinstance(node, ast.If) else "while"
        return (f"{kw}-tensor", f"{kw} on a tensor reduction reads it on "
                "the host (a sync when it lives on the card)")
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    seg = _last_seg(func)
    if isinstance(func, ast.Name) and seg in ("int", "float", "bool"):
        if node.args and not _is_static_metadata(node.args[0]):
            return (f"{seg}()", f"{seg}() of a value that may be a tensor "
                    "copies it to the host (exempt: constants, shape / "
                    "ndim / size / numel / len metadata)")
        return None
    if not isinstance(func, ast.Attribute):
        return None
    if seg in _SYNC_METHODS and not node.args:
        return (f".{seg}()", f".{seg}() copies a tensor to the host and "
                "waits for the card")
    if seg == "synchronize" and "cuda" in ast.unparse(func):
        return ("cuda.synchronize", "torch.cuda.synchronize waits for "
                "every queued kernel")
    if seg in ("tensor", "as_tensor") and _root_name(func) == "torch" and \
            any(kw.arg == "device" for kw in node.keywords):
        return (f"torch.{seg}(device=)", f"torch.{seg}(<host value>, "
                "device=...) is a pageable host-to-device copy")
    if seg == "to" and _device_arg(node):
        return (".to(device)", ".to(<device>) of a host tensor is a "
                "pageable host-to-device copy")
    return None


def _functions(tree: ast.Module, parents) -> Dict[str, ast.AST]:
    """Every function of the module by qualname."""
    return {_qualname(n, parents): n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _module_roots(tree: ast.Module) -> Tuple[str, ...]:
    """A module's own ``HOST_SYNC_ROOTS = (...)`` tuple of qualnames."""
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == "HOST_SYNC_ROOTS"):
            return tuple(ast.literal_eval(stmt.value))
    return ()


class _Module:
    def __init__(self, src: str, path: str) -> None:
        self.path = path
        self.tree = ast.parse(src, filename=path)
        p = _Parented()
        p.visit(self.tree)
        self.parents = p.parents
        self.functions = _functions(self.tree, self.parents)
        # names the module's imports bind (a module or a function)
        self.imported: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    self.imported.add((a.asname or a.name).split(".")[0])


def _targets(node: ast.AST, mod: _Module, q: str,
             top: Dict[str, List[Tuple["_Module", str]]]
             ) -> List[Tuple["_Module", str]]:
    """The functions a reference inside ``mod``'s function ``q`` can
    reach, called or passed on as a value (``fn = L.gqa_decode``): a bare
    name (a function of this module of that name, or a module-level one
    it imports), ``mod.f`` on an imported module (a module-level ``f``),
    ``self.f`` (this class's ``f``).  An attribute of any other object
    (``x.set``, ``server.run``) is not followed."""
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
        out = [(mod, g) for g in mod.functions
               if g.rsplit(".", 1)[-1] == node.id]
        if node.id in mod.imported:
            out.extend(top.get(node.id, ()))
        return out
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id == "self":
            g = q.split(".", 1)[0] + "." + node.attr
            return [(mod, g)] if g in mod.functions else []
        if node.value.id in mod.imported:
            return list(top.get(node.attr, ()))
    return []


def _roots_of(mod: _Module) -> List[str]:
    own = list(_module_roots(mod.tree))
    for suffix, names in HOST_SYNC_ROOTS.items():
        if mod.path.endswith("repro_torch/" + suffix):
            own.extend(names)
    return [q for q in own if q in mod.functions]


def _host_syncs(mods: Sequence[_Module]) -> List[Violation]:
    """Walk from every module's roots through calls by name (across
    ``mods``) and flag the syncs of every function reached."""
    top: Dict[str, List[Tuple[_Module, str]]] = {}  # module-level defs
    for mod in mods:
        for q in mod.functions:
            if "." not in q:
                top.setdefault(q, []).append((mod, q))
    frontier = [(mod, q) for mod in mods for q in _roots_of(mod)]
    seen: Set[Tuple[str, str]] = set()
    out: List[Violation] = []
    while frontier:
        mod, q = frontier.pop()
        if (mod.path, q) in seen:
            continue
        seen.add((mod.path, q))
        fn = mod.functions[q]
        for node in ast.walk(fn):
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a closure runs with its maker (a callback, a step_fn)
                frontier.append((mod, _qualname(node, mod.parents)))
                continue
            hit = _sync_of(node, fn)
            if hit is not None and _qualname(node, mod.parents) == q:
                out.append(Violation("host-sync", mod.path, node.lineno, q,
                                     hit[0], hit[1]))
            if isinstance(node, (ast.Name, ast.Attribute)):
                for target in _targets(node, mod, q, top):
                    if (target[0].path, target[1]) not in seen:
                        frontier.append(target)
    return sorted(set(out), key=lambda v: (v.path, v.line, v.detail))


# ---------------------------------------------------------------------------
# rule 2: f32 accumulators in comm/metrics accounting
# ---------------------------------------------------------------------------

# compound accounting names only: "comm_total", "bytes_total",
# "tokens_total", anything mentioning comm.  A bare local "total" (e.g.
# an on-device f32 metric reduction) is not accounting state.
_ACC_NAME_RE = re.compile(r"comm|\w_(?:total|bytes)$")
_NARROW = {"float32", "float16", "bfloat16", "f32", "f16", "bf16"}


def _target_names(target: ast.expr) -> Iterable[str]:
    for node in ast.walk(target):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr


def _mentions_narrow_float(expr: ast.expr) -> Optional[str]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _NARROW:
            return node.attr
        if isinstance(node, ast.Name) and node.id in _NARROW:
            return node.id
        if isinstance(node, ast.Constant) and node.value in _NARROW:
            return str(node.value)
    return None


def _f32_accumulators(tree: ast.Module, path: str,
                      parents: Dict[ast.AST, ast.AST]) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if node.value is None:
                continue
            targets, value = [node.target], node.value
        else:
            continue
        hit = None
        for t in targets:
            for name in _target_names(t):
                if _ACC_NAME_RE.search(name):
                    hit = name
                    break
            if hit:
                break
        if hit is None:
            continue
        narrow = _mentions_narrow_float(value)
        if narrow is not None:
            out.append(Violation(
                "f32-accumulator", path, node.lineno,
                _qualname(node, parents), f"{hit}:{narrow}",
                f"accounting name {hit!r} assigned via {narrow} — comm/"
                "metrics accumulators must stay exact float64 (Python "
                "float); see docs/OBSERVABILITY.md",
            ))
    return out


# ---------------------------------------------------------------------------
# rule 3: thread discipline
# ---------------------------------------------------------------------------

_SYNC_TYPES = {
    "Lock", "RLock", "Condition", "Event", "Semaphore", "BoundedSemaphore",
    "Barrier", "Queue", "SimpleQueue", "local", "Thread",
}
_LOCK_TYPES = {"Lock", "RLock", "Condition"}
_MUTATORS = {
    "append", "extend", "insert", "pop", "popleft", "appendleft", "remove",
    "clear", "update", "add", "discard", "setdefault",
}


def _self_attr(node: ast.expr) -> Optional[str]:
    """Innermost ``self.X`` attribute of a store/load chain:
    ``self.metrics[uid].admitted`` -> "metrics"."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


@dataclasses.dataclass
class _FnInfo:
    node: ast.AST
    qualname: str
    reads: List[Tuple[str, ast.AST, bool]]  # (attr, node, guarded)
    writes: List[Tuple[str, ast.AST, bool]]
    # (callee-name, guarded) for self.X() calls / property loads / bare
    # calls of sibling nested functions
    calls: List[Tuple[str, bool]]
    is_entry: bool = False  # a thread target


class _ClassScanner:
    """Per-class accounting for the thread-discipline rule."""

    def __init__(self, cls: ast.ClassDef,
                 parents: Dict[ast.AST, ast.AST]) -> None:
        self.cls = cls
        self.parents = parents
        self.fns: Dict[str, _FnInfo] = {}
        self.lock_attrs: Set[str] = set()
        self.sync_attrs: Set[str] = set()
        self.entries: Set[str] = set()
        self._scan()

    def _scan(self) -> None:
        # classify __init__-assigned sync primitives first
        for stmt in self.cls.body:
            if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name == "__init__"):
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Assign):
                        continue
                    if not (isinstance(node.value, ast.Call)
                            and _last_seg(node.value.func) in _SYNC_TYPES):
                        continue
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        self.sync_attrs.add(attr)
                        if _last_seg(node.value.func) in _LOCK_TYPES:
                            self.lock_attrs.add(attr)

        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_fn(stmt, stmt.name)

    # -- per-function walk, tracking lexical lock guards -----------------

    def _scan_fn(self, fn: ast.AST, name: str) -> None:
        info = _FnInfo(fn, name, [], [], [])
        self.fns[name] = info
        body = fn.body if isinstance(
            fn, (ast.FunctionDef, ast.AsyncFunctionDef)) else [fn.body]
        for stmt in body:
            self._walk(stmt, info, guarded=False)

    def _walk(self, node: ast.AST, info: _FnInfo, guarded: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested function: its own accounting unit (a thread target
            # candidate); lexical guards do not cross the boundary
            self._scan_fn(node, f"{info.qualname}.<locals>.{node.name}")
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locks_here = any(
                _self_attr(item.context_expr) in self.lock_attrs
                for item in node.items
            )
            for item in node.items:
                self._walk(item.context_expr, info, guarded)
            for stmt in node.body:
                self._walk(stmt, info, guarded or locks_here)
            return

        self._record(node, info, guarded)
        for child in ast.iter_child_nodes(node):
            self._walk(child, info, guarded)

    def _record(self, node: ast.AST, info: _FnInfo, guarded: bool) -> None:
        # thread spawns: Thread(target=X) / executor.submit(X, ...)
        if isinstance(node, ast.Call):
            seg = _last_seg(node.func)
            target: Optional[ast.expr] = None
            if seg == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
            elif seg == "submit" and node.args:
                target = node.args[0]
            if target is not None:
                tname = self._callable_name(target, info)
                if tname is not None:
                    self.entries.add(tname)

            callee = self._self_call(node.func)
            if callee is not None:
                info.calls.append((callee, guarded))
                return  # the func expr is a call edge, not a data read
            if isinstance(node.func, ast.Name):
                info.calls.append(
                    (f"{info.qualname}.<locals>.{node.func.id}", guarded))

        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    info.writes.append((attr, node, guarded))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    info.writes.append((attr, node, guarded))
        elif isinstance(node, ast.Call):
            # self.attr.append(...) and friends mutate the container
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS):
                attr = _self_attr(node.func.value)
                if attr is not None:
                    info.writes.append((attr, node, guarded))
        elif isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load):
            attr = _self_attr(node)
            if attr is None:
                return
            if attr in self.fns or attr in {
                s.name for s in self.cls.body
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
            }:
                # method or property reference -> call edge
                info.calls.append((attr, guarded))
            else:
                info.reads.append((attr, node, guarded))

    def _self_call(self, func: ast.expr) -> Optional[str]:
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"):
            return func.attr
        return None

    def _callable_name(self, target: ast.expr,
                       info: _FnInfo) -> Optional[str]:
        if isinstance(target, ast.Name):
            return f"{info.qualname}.<locals>.{target.id}"
        name = self._self_call(target)
        return name

    # -- analysis --------------------------------------------------------

    def violations(self, path: str) -> List[Violation]:
        # keep only spawn targets that resolve to a function of this
        # class: ``driver.submit(request)`` is a queue method taking a
        # Request, not an executor spawning ``request`` on a thread
        entries: Set[str] = set()
        for e in self.entries:
            r = e if e in self.fns else self._resolve(e)
            if r is not None and r in self.fns:
                entries.add(r)
        if not entries:
            return []

        # thread-reachable functions: closure over call edges from entries
        reachable: Set[str] = set()
        frontier = list(entries)
        while frontier:
            cur = frontier.pop()
            if cur in reachable:
                continue
            reachable.add(cur)
            for callee, _ in self.fns[cur].calls:
                resolved = self._resolve(callee)
                if resolved is not None and resolved not in reachable:
                    frontier.append(resolved)

        # greatest-fixpoint lock_held: f is lock-held when every one of
        # its call sites is lexically guarded or sits in a lock-held
        # caller.  Entries and call-site-free functions are never
        # lock-held (they can be entered from anywhere).
        sites: Dict[str, List[Tuple[str, bool]]] = {n: [] for n in self.fns}
        for caller, info in self.fns.items():
            for callee, guarded in info.calls:
                resolved = self._resolve(callee)
                if resolved is not None:
                    sites[resolved].append((caller, guarded))
        lock_held = {
            n: bool(sites[n]) and n not in entries and n != "__init__"
            for n in self.fns
        }
        changed = True
        while changed:
            changed = False
            for n, held in list(lock_held.items()):
                if not held:
                    continue
                ok = all(g or lock_held.get(c, False) for c, g in sites[n])
                if not ok:
                    lock_held[n] = False
                    changed = True

        thread_written: Set[str] = set()
        for n in reachable:
            if n == "__init__":
                continue
            for attr, _, _ in self.fns[n].writes:
                if attr not in self.sync_attrs:
                    thread_written.add(attr)

        out: List[Violation] = []
        for n, info in self.fns.items():
            if n == "__init__" or n.endswith(".<locals>.__init__"):
                continue
            held = lock_held.get(n, False)
            for attr, node, guarded in info.writes + info.reads:
                if attr not in thread_written or guarded or held:
                    continue
                kind = ("written" if any(
                    a == attr and nd is node for a, nd, _ in info.writes
                ) else "read")
                out.append(Violation(
                    "thread-discipline", path, node.lineno,
                    f"{self.cls.name}.{n}", f"attr:{attr}",
                    f"self.{attr} is written by the "
                    f"{'/'.join(sorted(entries))} thread but {kind} "
                    f"here without holding the lock "
                    f"({', '.join(sorted(self.lock_attrs)) or 'none found'})",
                ))
        return out

    def _resolve(self, callee: str) -> Optional[str]:
        if callee in self.fns:
            return callee
        # nested-name fallback: "<method>.<locals>.f" recorded from a
        # bare call may actually be a sibling method or a module function
        tail = callee.rsplit(".", 1)[-1]
        return tail if tail in self.fns else None


def _thread_discipline(tree: ast.Module, path: str,
                       parents: Dict[ast.AST, ast.AST]) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.extend(_ClassScanner(node, parents).violations(path))
    return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _lint_modules(mods: Sequence[_Module]) -> List[Violation]:
    out: List[Violation] = list(_host_syncs(mods))
    for mod in mods:
        out.extend(_f32_accumulators(mod.tree, mod.path, mod.parents))
        out.extend(_thread_discipline(mod.tree, mod.path, mod.parents))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_source(src: str, path: str = "<string>") -> List[Violation]:
    """All rules over one source string (host-sync reaches only into its
    own functions).  ``path`` labels the violations (use a repo-relative
    path so baseline keys are machine-independent)."""
    return _lint_modules([_Module(src, path)])


def _label(path: Path, root: Optional[Path]) -> str:
    return str(path.relative_to(root) if root else path).replace("\\", "/")


def lint_file(path: Path, root: Optional[Path] = None) -> List[Violation]:
    path = Path(path)
    return lint_source(path.read_text(), _label(path, root))


def lint_tree(root: Path,
              subdirs: Sequence[str] = ("src/repro_torch",)
              ) -> List[Violation]:
    """Lint every ``*.py`` under ``root``'s ``subdirs`` as one program
    (host-sync follows calls across modules); repo-relative paths."""
    root = Path(root)
    mods = [_Module(p.read_text(), _label(p, root))
            for sub in subdirs for p in sorted((root / sub).rglob("*.py"))]
    return _lint_modules(mods)


# ---------------------------------------------------------------------------
# checked suppression baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> Dict[str, str]:
    """``key  # justification`` lines -> {key: justification}.  Every
    entry MUST carry a justification comment — an unexplained waiver is a
    parse error, not a style nit."""
    out: Dict[str, str] = {}
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, why = line.partition("#")
        key, why = key.strip(), why.strip()
        if not sep or not why:
            raise ValueError(
                f"{path}:{lineno}: baseline entry {key!r} has no "
                "justification comment (format: 'key  # why this is ok')")
        out[key] = why
    return out


def apply_baseline(
    violations: Sequence[Violation], baseline: Dict[str, str],
) -> Tuple[List[Violation], List[str]]:
    """(unwaived violations, stale baseline keys).  A stale key — one
    matching no current violation — is an error at the caller: the code
    it excused is gone, so the waiver must go too."""
    keys = {v.key for v in violations}
    remaining = [v for v in violations if v.key not in baseline]
    stale = sorted(k for k in baseline if k not in keys)
    return remaining, stale
