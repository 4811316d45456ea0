"""Oniguruma patterns of ``tokenizer.json`` in Python's ``re``.

HF ``tokenizers`` compiles the ``Split`` pre-tokenizer's and the ``Replace``
normalizer's / decoder's ``{"Regex": ...}`` patterns with Oniguruma (Ruby
syntax, UTF-8). ``translate`` rewrites such a pattern for Python 3.12's ``re``:

- ``\\p{X}``, ``\\P{X}`` and ``\\p{^X}`` for the general categories (``L``,
  ``Lu``, ``Ll``, ``Lt``, ``Lm``, ``Lo``, ``M``, ``Mn``, ``Mc``, ``Me``,
  ``N``, ``Nd``, ``Nl``, ``No``, ``P`` and its seven, ``S`` and its four,
  ``Z`` and its three, ``C`` and its five) become classes built once a
  process from ``unicodedata``: code points assigned after this Python's
  Unicode version are unassigned (``Cn``) here;
- ``\\s`` is Unicode White_Space (``re``'s ``\\s`` wrongly adds U+001C-U+001F)
  and ``\\d`` decimal digits (``Nd``), as Oniguruma reads them for Unicode;
- groups (``(?:``, ``(?i:``, lookaround, atomic ``(?>``, named ``(?<n>``),
  greedy, lazy and possessive quantifiers, intervals and character classes
  carry over; ``^`` / ``$`` are line anchors, as in Ruby.

Anything else raises ``ValueError`` naming the construct: nested classes and
class intersection, POSIX brackets, backreferences, word boundaries, inline
flags other than ``i``, scripts, binary properties and long names, ``\\w`` / ``\\W``
(Oniguruma's word class is no union of categories), and ``{n,m}+``, which
Ruby reads as a repeated interval where ``re`` reads a possessive one.
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata
from typing import Dict, List, Tuple

Ranges = List[Tuple[int, int]]

_GROUPS = {"L": ("Lu", "Ll", "Lt", "Lm", "Lo"), "M": ("Mn", "Mc", "Me"),
           "N": ("Nd", "Nl", "No"), "P": ("Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po"),
           "S": ("Sm", "Sc", "Sk", "So"), "Z": ("Zs", "Zl", "Zp"),
           "C": ("Cc", "Cf", "Cs", "Co", "Cn")}
_SINGLE = {"n": "\n", "r": "\r", "t": "\t", "f": "\f", "v": "\v", "a": "\x07", "e": "\x1b"}


@functools.lru_cache(maxsize=1)
def _category_ranges() -> Dict[str, Ranges]:
    """Two-letter general category -> its code point ranges (one pass, ~0.4 s)."""
    out: Dict[str, Ranges] = {}
    prev, start = unicodedata.category("\0"), 0
    for c in range(1, sys.maxunicode + 1):
        cat = unicodedata.category(chr(c))
        if cat != prev:
            out.setdefault(prev, []).append((start, c - 1))
            prev, start = cat, c
    out.setdefault(prev, []).append((start, sys.maxunicode))
    return out


def _merge(ranges: Ranges) -> Ranges:
    out: Ranges = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _complement(ranges: Ranges) -> Ranges:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= sys.maxunicode:
        out.append((nxt, sys.maxunicode))
    return out


def _points(pred, stop: int) -> Ranges:
    return _merge([(c, c) for c in range(stop) if pred(c)])


@functools.lru_cache(maxsize=None)
def ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """The code point ranges of a general category (one or two letters) or of
    ``s`` (White_Space) and ``d`` (Oniguruma's Unicode classes)."""
    if name == "s":     # every White_Space code point lies below U+3001
        return tuple(_points(lambda c: chr(c).isspace() and not 0x1C <= c <= 0x1F, 0x3001))
    if name == "d":
        return ranges("Nd")
    if name in _GROUPS:
        return tuple(_merge([r for sub in _GROUPS[name] for r in _category_ranges().get(sub, [])]))
    if len(name) == 2 and name[0] in _GROUPS and name in _GROUPS[name[0]]:
        return tuple(_category_ranges().get(name, []))
    raise ValueError(f"unknown character class {name!r}")


def class_body(rs, negate: bool = False) -> str:
    """A ``re`` character-class body (without brackets) for ranges ``rs``."""
    rs = _complement(list(rs)) if negate else rs
    parts = []
    for lo, hi in rs:
        a = re.escape(chr(lo))
        parts.append(a if lo == hi else f"{a}-{re.escape(chr(hi))}")
    return "".join(parts)


def _property(name: str) -> str:
    """The category letter(s) of ``\\p{name}``."""
    if name in _GROUPS or (len(name) == 2 and name[0] in _GROUPS and name in _GROUPS[name[0]]):
        return name
    raise ValueError(f"unsupported Unicode property \\p{{{name}}}: only general categories "
                     "are translated")


def _hex(pattern: str, i: int, n: int) -> Tuple[str, int]:
    digits = pattern[i:i + n]
    if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
        raise ValueError(f"bad hex escape at {i} in {pattern!r}")
    return chr(int(digits, 16)), i + n


def _escape(pattern: str, i: int) -> Tuple[str, object, int]:
    """Read the escape whose backslash is at ``i``: ("char", c, next),
    ("class", body, next) or ("raw", re_text, next)."""
    if i + 1 >= len(pattern):
        raise ValueError(f"pattern ends with a backslash: {pattern!r}")
    c = pattern[i + 1]
    j = i + 2
    if c in "pP":
        if j >= len(pattern) or pattern[j] != "{":
            raise ValueError(f"\\{c} without braces in {pattern!r}")
        end = pattern.find("}", j)
        if end < 0:
            raise ValueError(f"unterminated \\{c}{{ in {pattern!r}")
        name = pattern[j + 1:end]
        negate = c == "P"
        if name.startswith("^"):
            negate, name = not negate, name[1:]
        return "class", class_body(ranges(_property(name)), negate), end + 1
    if c in "sSdD":
        return "class", class_body(ranges(c.lower()), c.isupper()), j
    if c in _SINGLE:
        return "char", _SINGLE[c], j
    if c == "x":
        if j < len(pattern) and pattern[j] == "{":
            end = pattern.find("}", j)
            if end < 0 or not pattern[j + 1:end] or len(pattern[j + 1:end]) > 8:
                raise ValueError(f"bad \\x{{...}} escape in {pattern!r}")
            ch, _ = _hex(pattern, j + 1, end - j - 1)
            return "char", ch, end + 1
        ch, k = _hex(pattern, j, 2)
        return "char", ch, k
    if c == "u":
        ch, k = _hex(pattern, j, 4)
        return "char", ch, k
    if c == "A":
        return "raw", r"\A", j
    if c == "z":
        return "raw", r"\Z", j
    if c == "Z":
        return "raw", r"(?=\n?\Z)", j
    if c.isalnum() or c == "_":
        raise ValueError(f"unsupported escape \\{c} in {pattern!r}")
    return "char", c, j


def _char_class(pattern: str, i: int) -> Tuple[str, int]:
    """Translate the class whose ``[`` is at ``i``; return (re text, next index)."""
    j = i + 1
    out = ["["]
    if j < len(pattern) and pattern[j] == "^":
        out.append("^")
        j += 1
    first = True
    while True:
        if j >= len(pattern):
            raise ValueError(f"unterminated character class in {pattern!r}")
        c = pattern[j]
        if c == "]" and not first:
            out.append("]")
            return "".join(out), j + 1
        if c == "[":
            raise ValueError(f"nested character class or POSIX bracket at {j} in {pattern!r}")
        if pattern.startswith("&&", j):
            raise ValueError(f"character class intersection (&&) in {pattern!r}")
        if c == "\\":
            kind, value, j = _escape(pattern, j)
            if kind == "raw":
                raise ValueError(f"anchor inside a character class in {pattern!r}")
            out.append(value if kind == "class" else re.escape(value))
        else:
            out.append(c if c == "-" else re.escape(c))
            j += 1
        first = False


def translate(pattern: str) -> str:
    """The ``re`` pattern equivalent to Oniguruma ``pattern`` (see the module
    docstring); ``ValueError`` names what cannot be translated."""
    out: List[str] = []
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            kind, value, i = _escape(pattern, i)
            out.append(f"[{value}]" if kind == "class" else value if kind == "raw"
                       else re.escape(value))
        elif c == "[":
            text, i = _char_class(pattern, i)
            out.append(text)
        elif c == "(":
            if pattern.startswith("(?", i):
                rest = pattern[i + 2:]
                for lead in (":", "=", "!", "<=", "<!", ">"):
                    if rest.startswith(lead):
                        out.append("(?" + lead)
                        i += 2 + len(lead)
                        break
                else:
                    m = re.match(r"<([A-Za-z_]\w*)>", rest)
                    if m:
                        out.append(f"(?P<{m.group(1)}>")
                        i += 2 + m.end()
                    elif rest.startswith("i:"):
                        out.append("(?i:")
                        i += 4
                    elif rest.startswith("i)") and i == 0:
                        out.append("(?i)")
                        i += 4
                    else:
                        raise ValueError(f"unsupported group or inline flag "
                                         f"{pattern[i:i + 5]!r}... in {pattern!r}")
            else:
                out.append("(")
                i += 1
        elif c == "{":
            m = re.match(r"\{(\d*),?(\d*)\}", pattern[i:])
            if m and (m.group(1) or m.group(2)):
                i += m.end()
                if i < n and pattern[i] == "+":
                    raise ValueError(f"{m.group(0)}+ (a repeated interval in Ruby syntax, "
                                     f"possessive in re) in {pattern!r}")
                out.append(m.group(0))
            else:
                out.append(r"\{")
                i += 1
        elif c == "^":
            out.append("(?m:^)")
            i += 1
        elif c == "$":
            out.append("(?m:$)")
            i += 1
        else:
            out.append(c if c in ".|)*+?" else re.escape(c))
            i += 1
    return "".join(out)


@functools.lru_cache(maxsize=64)
def compile_onig(pattern: str) -> "re.Pattern":
    """``re.compile(translate(pattern))``, cached per process."""
    return re.compile(translate(pattern))
