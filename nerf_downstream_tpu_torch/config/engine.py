"""Core of the gin-compatible config engine.

Statement language supported (superset of what the reference's .gin files use):

    name.param = <value>          # binding
    name.param = @other           # reference to a configurable (callable)
    name.param = @other()         # evaluated reference (called at inject time)
    MACRO = <value>               # macro definition (uppercase, no dot)
    name.param = %MACRO           # macro use
    include 'path/to/file.gin'    # file inclusion
    import some.module            # module import (executed for registration)

Values are python literals (ast.literal_eval), spanning multiple lines when
brackets are open. ``#`` starts a comment outside string literals.

Precedence: later statements win ("later --ginc wins; --ginb wins over all",
reference co3d_3d/README.md:37-40).
"""

from __future__ import annotations

import ast
import functools
import importlib
import inspect
import os
import threading
from typing import Any, Callable


class ConfigError(Exception):
    pass


class _Registry:
    def __init__(self):
        self.configurables: dict[str, Callable] = {}
        # every callable registered under a name (the 2D and the 3D
        # RandomHorizontalFlip share one), for check_bindings
        self.registered: dict[str, list[Callable]] = {}
        self.bindings: dict[str, dict[str, Any]] = {}
        self.macros: dict[str, Any] = {}
        self.operative: dict[str, dict[str, Any]] = {}
        self.imports: list[str] = []
        self.lock = threading.RLock()


_REG = _Registry()


class _Reference:
    """An ``@name`` or ``@name()`` value inside a config file."""

    __slots__ = ("name", "evaluated")

    def __init__(self, name: str, evaluated: bool):
        self.name = name
        self.evaluated = evaluated

    def resolve(self):
        fn = get_configurable(self.name)
        return fn() if self.evaluated else fn

    def __repr__(self):
        return f"@{self.name}" + ("()" if self.evaluated else "")

    def __eq__(self, other):
        return (
            isinstance(other, _Reference)
            and other.name == self.name
            and other.evaluated == self.evaluated
        )


class _Macro:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"%{self.name}"


def clear_config(clear_constants: bool = True):
    with _REG.lock:
        _REG.bindings.clear()
        _REG.operative.clear()
        if clear_constants:
            _REG.macros.clear()


def register(name: str, fn: Callable):
    with _REG.lock:
        _REG.configurables[name] = fn
        if fn is not None:  # not the placeholder of ``wrap``
            _REG.registered.setdefault(name, []).append(fn)


def get_configurable(name: str) -> Callable:
    try:
        return _REG.configurables[name]
    except KeyError:
        raise ConfigError(f"No configurable registered under name {name!r}")


def _resolve_value(v):
    if isinstance(v, _Reference):
        return v.resolve()
    if isinstance(v, _Macro):
        if v.name not in _REG.macros:
            raise ConfigError(f"Undefined macro %{v.name}")
        return _resolve_value(_REG.macros[v.name])
    if isinstance(v, list):
        return [_resolve_value(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_resolve_value(x) for x in v)
    if isinstance(v, dict):
        return {k: _resolve_value(x) for k, x in v.items()}
    return v


def configurable(fn_or_name=None, *, name: str | None = None, denylist=()):
    """Decorator mirroring ``gin.configurable``.

    Bound parameters are injected as keyword defaults at call time; arguments
    passed explicitly by the caller always win (gin semantics). Classes stay
    classes (``__init__`` is wrapped in place) so subclassing keeps working.
    """

    def wrap_class(cls, reg_name: str):
        orig_init = cls.__init__
        try:
            sig = inspect.signature(orig_init)
            has_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()
            )
            param_names = {
                p.name
                for p in sig.parameters.values()
                if p.name != "self"
                and p.kind
                in (
                    inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    inspect.Parameter.KEYWORD_ONLY,
                )
            }
            pos_names = [
                p.name
                for p in sig.parameters.values()
                if p.name != "self"
                and p.kind
                in (
                    inspect.Parameter.POSITIONAL_ONLY,
                    inspect.Parameter.POSITIONAL_OR_KEYWORD,
                )
            ]
        except (TypeError, ValueError):
            has_var_kw, param_names, pos_names = True, set(), []

        @functools.wraps(orig_init)
        def __init__(self, *args, **kwargs):
            bound = _REG.bindings.get(reg_name, {})
            inject = {}
            for k, v in bound.items():
                if k in denylist:
                    continue
                if not has_var_kw and k not in param_names:
                    raise ConfigError(
                        f"Binding {reg_name}.{k} does not match any "
                        f"parameter of {cls.__name__}.__init__"
                    )
                inject[k] = _resolve_value(v)
            for pname in pos_names[: len(args)]:
                inject.pop(pname, None)
            inject.update(kwargs)
            orig_init(self, *args, **inject)

        cls.__init__ = __init__
        register(reg_name, cls)
        cls.__gin_name__ = reg_name
        cls.__gin_params__ = None if has_var_kw else param_names
        return cls

    def wrap(fn: Callable, reg_name: str):
        register(reg_name, None)  # placeholder to reserve name
        if inspect.isclass(fn):
            return wrap_class(fn, reg_name)

        try:
            sig = inspect.signature(fn)
            has_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()
            )
            param_names = {
                p.name
                for p in sig.parameters.values()
                if p.kind
                in (
                    inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    inspect.Parameter.KEYWORD_ONLY,
                )
            }
        except (TypeError, ValueError):
            sig, has_var_kw, param_names = None, True, set()

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = _REG.bindings.get(reg_name, {})
            inject = {}
            for k, v in bound.items():
                if k in denylist:
                    continue
                if not has_var_kw and k not in param_names:
                    raise ConfigError(
                        f"Binding {reg_name}.{k} does not match any parameter "
                        f"of {fn.__qualname__}"
                    )
                inject[k] = _resolve_value(v)
            # Explicitly passed positional args win over injected kwargs.
            if sig is not None and args:
                pos_names = [
                    p.name
                    for p in sig.parameters.values()
                    if p.kind
                    in (
                        inspect.Parameter.POSITIONAL_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    )
                ]
                for pname in pos_names[: len(args)]:
                    inject.pop(pname, None)
            inject.update(kwargs)
            if inject:
                _REG.operative.setdefault(reg_name, {}).update(
                    {k: inject[k] for k in bound if k in inject}
                )
            return fn(*args, **inject)

        register(reg_name, wrapper)
        wrapper.__gin_name__ = reg_name
        wrapper.__gin_params__ = None if has_var_kw else param_names
        return wrapper

    if callable(fn_or_name):
        return wrap(fn_or_name, name or fn_or_name.__name__)
    if isinstance(fn_or_name, str):
        return lambda fn: wrap(fn, fn_or_name)
    return lambda fn: wrap(fn, name or fn.__name__)


def check_bindings():
    """Raise ``ConfigError`` unless every binding names a registered
    configurable and one of its parameters (a call would raise later;
    this says so before a run starts)."""
    bad = []
    for name, params in sorted(_REG.bindings.items()):
        fn = _REG.configurables.get(name)
        if fn is None:
            bad.append(f"{name} (no configurable of that name)")
            continue
        takes = [getattr(f, "__gin_params__", None)
                 for f in _REG.registered.get(name, [fn])]
        if None not in takes:
            known = set().union(*takes)
            bad += [f"{name}.{p}" for p in sorted(params) if p not in known]
    if bad:
        raise ConfigError(f"Bindings that match no configurable or "
                          f"parameter: {bad}")


def external_configurable(fn: Callable, name: str | None = None, denylist=()):
    """Register a callable we don't own (mirrors gin.external_configurable)."""
    return configurable(name=name or fn.__name__, denylist=denylist)(fn)


def constant(name: str, value):
    _REG.macros[name] = value
    return value


def bind(name: str, param: str, value):
    with _REG.lock:
        _REG.bindings.setdefault(name, {})[param] = value


def query_parameter(path: str, default=..., _raise: bool = True):
    """``gin.query_parameter("train.max_steps")`` equivalent."""
    if path.startswith("%"):
        mname = path[1:]
        if mname in _REG.macros:
            return _resolve_value(_REG.macros[mname])
        if default is not ...:
            return default
        raise ConfigError(f"Undefined macro {path}")
    if "." not in path:
        raise ConfigError(f"Malformed parameter path {path!r}")
    name, param = path.rsplit(".", 1)
    binding = _REG.bindings.get(name, {})
    if param in binding:
        return _resolve_value(binding[param])
    if default is not ...:
        return default
    raise ConfigError(f"No binding for {path}")


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    out = []
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            out.append(c)
            if c == quote and (i == 0 or line[i - 1] != "\\"):
                quote = None
        elif c in "'\"":
            quote = c
            out.append(c)
        elif c == "#":
            break
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _bracket_depth_delta(s: str) -> int:
    depth = 0
    quote = None
    for i, c in enumerate(s):
        if quote:
            if c == quote and (i == 0 or s[i - 1] != "\\"):
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
    return depth


class _ValueTransformer(ast.NodeTransformer):
    """Rewrites @ref / %macro placeholders (pre-substituted) — see _parse_value."""


def _parse_value(text: str):
    """Parse a gin value: python literal extended with @refs and %macros."""
    text = text.strip()

    # Tokenize @references and %macros by substituting sentinel calls, then
    # rebuild via ast so they can appear nested inside lists/tuples/dicts.
    def substitute(src: str) -> str:
        out = []
        i = 0
        quote = None
        while i < len(src):
            c = src[i]
            if quote:
                out.append(c)
                if c == quote and src[i - 1] != "\\":
                    quote = None
                i += 1
            elif c in "'\"":
                quote = c
                out.append(c)
                i += 1
            elif c == "@" or c == "%":
                j = i + 1
                while j < len(src) and (src[j].isalnum() or src[j] in "._/"):
                    j += 1
                ident = src[i + 1 : j]
                if not ident:
                    raise ConfigError(f"Dangling {c!r} in value: {src!r}")
                evaluated = False
                if c == "@" and src[j : j + 2] == "()":
                    evaluated = True
                    j += 2
                if c == "@":
                    out.append(
                        f"__gin_ref__({ident!r}, {evaluated})"
                    )
                else:
                    out.append(f"__gin_macro__({ident!r})")
                i = j
            else:
                out.append(c)
                i += 1
        return "".join(out)

    src = substitute(text)

    def _eval(node):
        if isinstance(node, ast.Expression):
            return _eval(node.body)
        if isinstance(node, ast.Call):
            fname = getattr(node.func, "id", None)
            if fname == "__gin_ref__":
                return _Reference(node.args[0].value, node.args[1].value)
            if fname == "__gin_macro__":
                return _Macro(node.args[0].value)
            raise ConfigError(f"Calls are not allowed in config values: {text!r}")
        if isinstance(node, ast.List):
            return [_eval(e) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(_eval(e) for e in node.elts)
        if isinstance(node, ast.Set):
            return {_eval(e) for e in node.elts}
        if isinstance(node, ast.Dict):
            return {
                _eval(k): _eval(v) for k, v in zip(node.keys, node.values)
            }
        try:
            return ast.literal_eval(node)
        except (ValueError, TypeError) as e:
            raise ConfigError(f"Unparseable config value: {text!r}") from e

    try:
        tree = ast.parse(src, mode="eval")
    except SyntaxError as e:
        raise ConfigError(f"Syntax error in config value {text!r}") from e
    return _eval(tree)


def _iter_statements(text: str):
    """Yield logical statements, joining lines while brackets stay open."""
    buf = ""
    depth = 0
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() and depth == 0:
            continue
        buf = (buf + "\n" + line) if buf else line
        depth += _bracket_depth_delta(line)
        if depth > 0:
            continue
        if buf.strip():
            yield buf.strip()
        buf, depth = "", 0
    if buf.strip():
        yield buf.strip()


def parse_config(text: str, base_dir: str | None = None):
    for stmt in _iter_statements(text):
        _exec_statement(stmt, base_dir)


def _exec_statement(stmt: str, base_dir: str | None):
    if stmt.startswith("include"):
        rest = stmt[len("include") :].strip()
        path = ast.literal_eval(rest)
        if base_dir and not os.path.isabs(path):
            cand = os.path.join(base_dir, path)
            path = cand if os.path.exists(cand) else path
        parse_config_file(path)
        return
    if stmt.startswith("import "):
        mod = stmt[len("import ") :].strip()
        _REG.imports.append(mod)
        importlib.import_module(mod)
        return
    if "=" not in stmt:
        raise ConfigError(f"Malformed config statement: {stmt!r}")
    lhs, rhs = stmt.split("=", 1)
    lhs = lhs.strip()
    value = _parse_value(rhs)
    if "." not in lhs:
        # macro definition
        _REG.macros[lhs] = value
        return
    # Gin allows scoped names like `scope/name.param`; we keep the full
    # dotted path up to the last dot as the configurable name.
    name, param = lhs.rsplit(".", 1)
    name = name.split("/")[-1]
    bind(name, param, value)


def parse_config_file(path: str):
    with open(path) as f:
        parse_config(f.read(), base_dir=os.path.dirname(path))


def parse_config_files_and_bindings(
    config_files=None, bindings=None, finalize_config: bool = True, **_
):
    """Entry point matching gin's signature as used by the reference CLIs.

    Later config files override earlier ones; bindings override everything
    (reference co3d_3d/README.md:37-40).
    """
    for path in config_files or []:
        parse_config_file(path)
    for b in bindings or []:
        parse_config(b)


def _fmt(v) -> str:
    return repr(v)


def config_str() -> str:
    lines = []
    for mname in sorted(_REG.macros):
        lines.append(f"{mname} = {_fmt(_REG.macros[mname])}")
    for name in sorted(_REG.bindings):
        for param in sorted(_REG.bindings[name]):
            lines.append(f"{name}.{param} = {_fmt(_REG.bindings[name][param])}")
    return "\n".join(lines) + ("\n" if lines else "")


def operative_config_str() -> str:
    lines = []
    for name in sorted(_REG.operative):
        for param in sorted(_REG.operative[name]):
            lines.append(
                f"{name}.{param} = {_fmt(_REG.operative[name][param])}"
            )
    return "\n".join(lines) + ("\n" if lines else "")
