"""Declarative CLI option system (reference ``gm_useropt``,
``apps/output_cpp/gm_graph/inc/gm_useropt.h:20-60``); a copy of
``green_marl_tpu/cli/useropt.py``, which the port cannot import.

Options are typed, have defaults and help text, and are passed as
``-Name=value`` (the reference's convention, e.g. ``-GMNumThreads=32``);
arguments are positional.  Procedure scalar inputs auto-register as
options, mirroring ``gm_default_usermain.cc:123``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

_BOOL = {"true": True, "false": False, "1": True, "0": False}


@dataclass
class _Opt:
    name: str
    type: type
    default: Optional[str]
    help: str


class UserOpt:
    def __init__(self, prog: str, desc: str = ""):
        self.prog = prog
        self.desc = desc
        self._opts: Dict[str, _Opt] = {}
        self._args: List[_Opt] = []
        self._values: Dict[str, Any] = {}
        self._arg_values: List[str] = []

    def add_option(self, name: str, typ: type, default: Optional[str],
                   help: str = "") -> None:
        self._opts[name] = _Opt(name, typ, default, help)

    def add_argument(self, name: str, help: str = "") -> None:
        self._args.append(_Opt(name, str, None, help))

    def _parse_value(self, opt: _Opt, raw: str) -> Any:
        if opt.type is bool:
            return _BOOL[raw.lower()]
        return opt.type(raw)

    def parse(self, argv: List[str]) -> bool:
        pos: List[str] = []
        for tok in argv:
            if tok in ("-h", "-?", "--help"):
                self.print_help()
                return False
            if tok.startswith("-") and not tok[1:2].isdigit():
                body = tok.lstrip("-")
                name, _, raw = body.partition("=")
                if name not in self._opts:
                    print(f"unknown option: {tok}", file=sys.stderr)
                    self.print_help()
                    return False
                opt = self._opts[name]
                self._values[name] = self._parse_value(opt, raw or "1")
            else:
                pos.append(tok)
        self._arg_values = pos
        return True

    def get_option(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        opt = self._opts[name]
        if opt.default is None:
            return None
        return self._parse_value(opt, opt.default)

    def has_option(self, name: str) -> bool:
        return name in self._values or self._opts[name].default is not None

    def get_arg(self, i: int) -> Optional[str]:
        return self._arg_values[i] if i < len(self._arg_values) else None

    @property
    def num_args(self) -> int:
        return len(self._arg_values)

    def print_help(self) -> None:
        print(f"usage: {self.prog} [options] " +
              " ".join(f"<{a.name}>" for a in self._args))
        if self.desc:
            print(self.desc)
        print("options:")
        for o in self._opts.values():
            d = f" (default: {o.default})" if o.default is not None else ""
            print(f"  -{o.name}=<{o.type.__name__}>  {o.help}{d}")
        for a in self._args:
            print(f"  {a.name}: {a.help}")
