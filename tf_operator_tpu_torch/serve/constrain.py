"""Structured and constrained decoding: the host-side constraint compiler
and the paged constraint pool, in PyTorch.

Counterpart of ``tf_operator_tpu/serve/constrain.py``. The host half is a
whole copy (the port imports nothing of the JAX package): a request's
``json_schema``/``regex``/``choices`` spec compiles into a token-level DFA
over the model vocabulary (regex -> Thompson NFA -> subset-construction
DFA over the vocab charset, a schema through a regex over canonical JSON,
choices through a character trie), closed over the tokenizer into
``allow [n_states, vocab] bool`` and ``next [n_states, vocab] int32``
tables with ``accept``/``complete`` flags (:class:`CompiledProgram`).
:class:`ConstraintCompiler` caches programs LRU by a digest of (spec, eos,
vocab) and raises the typed :class:`InvalidGrammar` (a 400) on a bad spec;
it runs off the device lock (the scheduler's enqueue, HTTP threads).
``stop`` sequences encode to token-id sequences matched on the host at
delivery (:func:`match_stop`, :func:`apply_stop`).

:class:`ProgramPool` holds the device side on the engine's device: one
``allow_pool [rows, vocab] bool`` and one ``next_pool [rows, vocab]
int32`` of absolute successor rows, row 0 the always-allow program (mask
all-pass, next always 0) that unconstrained lanes read. A program binds
into a contiguous row range with a refcount; refcount-0 programs evict LRU
when a bind needs their rows. A slot's FSM state is one int32 row index
on the device, so the decode step adds ``where(allow_pool[fsm], 0.0,
-1e30)`` to every lane's logits before sampling and advances ``fsm =
next_pool[fsm, token]`` without a host sync; +0.0 leaves an unconstrained
lane's choice unchanged.

:func:`constrained_generate` is the solo oracle: ``generate``'s prefill
and decode loop with the mask add and FSM advance at the engine's op
positions, so a constrained engine lane gives its tokens for a seed.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from collections.abc import Sequence
from typing import Any

import numpy as np
import torch

from tf_operator_tpu_torch.runtime.metrics import (
    SERVE_CONSTRAIN_EVICTIONS,
    SERVE_CONSTRAIN_PROGRAMS,
)
from tf_operator_tpu_torch.serve.resilience import InvalidGrammar

# The additive-mask fill, matching _nucleus_filter's: large enough that
# softmax/argmax can never resurrect a masked token, finite so f32
# arithmetic (logsumexp shifts, temperature division) stays NaN-free.
NEG_MASK = -1e30

# Compile-budget caps: a DFA past these is a client error (typed 400),
# not an OOM — the pool rows are the real resource.
MAX_DFA_STATES = 512
MAX_REPEAT = 64


# ---------------------------------------------------------------------------
# regex → NFA (Thompson construction over the vocab charset)
# ---------------------------------------------------------------------------

_ESCAPE_CLASSES = {
    "d": "0123456789",
    "w": ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
          "abcdefghijklmnopqrstuvwxyz0123456789_"),
    "s": " \t\n\r",
}


class _Nfa:
    """Mutable Thompson NFA: per-state char→{states} plus ε-edges."""

    def __init__(self) -> None:
        self.chars: list[dict[str, set[int]]] = []
        self.eps: list[set[int]] = []

    def state(self) -> int:
        self.chars.append({})
        self.eps.append(set())
        return len(self.chars) - 1

    def edge(self, a: int, ch: str, b: int) -> None:
        self.chars[a].setdefault(ch, set()).add(b)

    def eedge(self, a: int, b: int) -> None:
        self.eps[a].add(b)


class _RegexParser:
    """Recursive-descent parser for the supported regex subset:
    literals, ``.``, escapes (incl. ``\\d \\w \\s``), ``[...]`` classes
    with ranges and negation, grouping ``( )``, alternation ``|``, and
    the quantifiers ``* + ? {m} {m,} {m,n}`` (bounded expansion). The
    AST is tuples; compilation resolves classes against the vocab
    alphabet (chars outside it can never be generated, so they simply
    have no edges)."""

    def __init__(self, pattern: str) -> None:
        self.p = pattern
        self.i = 0

    def fail(self, why: str) -> "InvalidGrammar":
        return InvalidGrammar(
            f"regex error at offset {self.i}: {why} (pattern {self.p!r})"
        )

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        if self.i >= len(self.p):
            raise self.fail("unexpected end of pattern")
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            raise self.fail(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self):
        branches = [self.concat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.concat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def concat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.repeat())
        if not parts:
            return ("empty",)
        return ("cat", parts) if len(parts) > 1 else parts[0]

    def repeat(self):
        node = self.atom()
        while self.peek() in ("*", "+", "?", "{"):
            op = self.take()
            if op == "*":
                node = ("rep", node, 0, None)
            elif op == "+":
                node = ("rep", node, 1, None)
            elif op == "?":
                node = ("rep", node, 0, 1)
            else:
                node = ("rep", node, *self._bounds())
        return node

    def _bounds(self) -> tuple[int, int | None]:
        digits = ""
        while (c := self.peek()) is not None and c.isdigit():
            digits += self.take()
        if not digits:
            raise self.fail("expected digits in {m,n}")
        lo = int(digits)
        hi: int | None = lo
        if self.peek() == ",":
            self.take()
            digits = ""
            while (c := self.peek()) is not None and c.isdigit():
                digits += self.take()
            hi = int(digits) if digits else None
        if self.take() != "}":
            raise self.fail("unterminated {m,n}")
        if hi is not None and hi < lo:
            raise self.fail(f"bad repeat bounds {{{lo},{hi}}}")
        if lo > MAX_REPEAT or (hi or 0) > MAX_REPEAT:
            raise self.fail(f"repeat bound exceeds {MAX_REPEAT}")
        return lo, hi

    def atom(self):
        ch = self.take()
        if ch == "(":
            node = self.alt()
            if self.peek() != ")":
                raise self.fail("unterminated group")
            self.take()
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            return ("any",)
        if ch == "\\":
            return self._escape(in_class=False)
        if ch in "*+?{":
            raise self.fail(f"quantifier {ch!r} with nothing to repeat")
        return ("lit", ch)

    def _escape(self, *, in_class: bool):
        ch = self.take()
        if ch in _ESCAPE_CLASSES:
            return ("class", frozenset(_ESCAPE_CLASSES[ch]), False)
        if ch == "n":
            return ("lit", "\n")
        if ch == "t":
            return ("lit", "\t")
        if ch == "r":
            return ("lit", "\r")
        # Everything else escapes to its literal self (\. \\ \[ \" …).
        return ("lit", ch)

    def _char_class(self):
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        chars: set[str] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.fail("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            c = self.take()
            if c == "\\":
                sub = self._escape(in_class=True)
                if sub[0] == "class":
                    chars |= set(sub[1])
                    continue
                c = sub[1]
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()
                hi = self.take()
                if hi == "\\":
                    hi = self._escape(in_class=True)[1]
                if ord(hi) < ord(c):
                    raise self.fail(f"bad class range {c}-{hi}")
                chars |= {chr(o) for o in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        return ("class", frozenset(chars), negated)


def _nfa_compile(node, nfa: _Nfa, alphabet: Sequence[str]) -> tuple[int, int]:
    """Thompson-construct ``node`` into ``nfa``; returns (start, end).
    Classes/``.``/negations resolve against ``alphabet`` — the vocab
    charset — here, so the DFA never carries unreachable characters."""
    kind = node[0]
    if kind == "empty":
        s = nfa.state()
        return s, s
    if kind == "lit":
        a, b = nfa.state(), nfa.state()
        nfa.edge(a, node[1], b)
        return a, b
    if kind == "any":
        a, b = nfa.state(), nfa.state()
        for ch in alphabet:
            if ch != "\n":
                nfa.edge(a, ch, b)
        return a, b
    if kind == "class":
        _, chars, negated = node
        a, b = nfa.state(), nfa.state()
        for ch in alphabet:
            if (ch in chars) != negated:
                nfa.edge(a, ch, b)
        return a, b
    if kind == "alt":
        a, b = nfa.state(), nfa.state()
        for br in node[1]:
            s, e = _nfa_compile(br, nfa, alphabet)
            nfa.eedge(a, s)
            nfa.eedge(e, b)
        return a, b
    if kind == "cat":
        start = prev = None
        for part in node[1]:
            s, e = _nfa_compile(part, nfa, alphabet)
            if start is None:
                start = s
            else:
                nfa.eedge(prev, s)
            prev = e
        return start, prev
    if kind == "rep":
        _, inner, lo, hi = node
        start = prev = nfa.state()
        for _ in range(lo):
            s, e = _nfa_compile(inner, nfa, alphabet)
            nfa.eedge(prev, s)
            prev = e
        if hi is None:
            # Kleene tail: loop the inner once-or-more, skippable.
            s, e = _nfa_compile(inner, nfa, alphabet)
            nfa.eedge(prev, s)
            nfa.eedge(e, s)
            end = nfa.state()
            nfa.eedge(prev, end)
            nfa.eedge(e, end)
            return start, end
        end = nfa.state()
        nfa.eedge(prev, end)
        for _ in range(hi - lo):
            s, e = _nfa_compile(inner, nfa, alphabet)
            nfa.eedge(prev, s)
            prev = e
            nfa.eedge(prev, end)
        return start, end
    raise InvalidGrammar(f"unsupported regex node {kind!r}")


def _eps_closure(nfa: _Nfa, states: frozenset[int]) -> frozenset[int]:
    out = set(states)
    stack = list(states)
    while stack:
        for nxt in nfa.eps[stack.pop()]:
            if nxt not in out:
                out.add(nxt)
                stack.append(nxt)
    return frozenset(out)


def _char_dfa(pattern: str, alphabet: Sequence[str],
              max_states: int) -> tuple[list[dict[str, int]], list[bool]]:
    """regex → char-level DFA over ``alphabet`` (subset construction),
    with dead (accept-unreachable) states pruned. Returns
    (transitions, accept); state 0 is the start."""
    ast = _RegexParser(pattern).parse()
    nfa = _Nfa()
    start, end = _nfa_compile(ast, nfa, alphabet)
    start_set = _eps_closure(nfa, frozenset((start,)))
    index = {start_set: 0}
    order = [start_set]
    trans: list[dict[str, int]] = [{}]
    todo = [start_set]
    while todo:
        cur = todo.pop()
        ci = index[cur]
        for ch in alphabet:
            nxt = set()
            for st in cur:
                nxt |= nfa.chars[st].get(ch, set())
            if not nxt:
                continue
            closed = _eps_closure(nfa, frozenset(nxt))
            if closed not in index:
                if len(index) >= max_states:
                    raise InvalidGrammar(
                        f"constraint DFA exceeds {max_states} states — "
                        "simplify the pattern or bound its repeats"
                    )
                index[closed] = len(order)
                order.append(closed)
                trans.append({})
                todo.append(closed)
            trans[ci][ch] = index[closed]
    accept = [end in st for st in order]
    return _prune_char_dead(trans, accept)


def _prune_char_dead(
    trans: list[dict[str, int]], accept: list[bool],
) -> tuple[list[dict[str, int]], list[bool]]:
    """Drop states that cannot reach an accept state (reverse BFS), so
    the token closure never offers a char path that strands generation."""
    n = len(trans)
    rev: list[set[int]] = [set() for _ in range(n)]
    for s, edges in enumerate(trans):
        for d in edges.values():
            rev[d].add(s)
    live = {s for s in range(n) if accept[s]}
    stack = list(live)
    while stack:
        for p in rev[stack.pop()]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise InvalidGrammar(
            "constraint matches nothing expressible with this vocabulary"
        )
    remap = {old: new for new, old in enumerate(sorted(live))}
    out_trans = [
        {ch: remap[d] for ch, d in trans[old].items() if d in live}
        for old in sorted(live)
    ]
    out_accept = [accept[old] for old in sorted(live)]
    return out_trans, out_accept


def _choices_dfa(
    choices: Sequence[str],
) -> tuple[list[dict[str, int]], list[bool]]:
    """Character trie of the literal choices — states are prefixes.
    Equivalent to the DFA of an escaped alternation, built directly."""
    if not choices:
        raise InvalidGrammar("choices must be a non-empty list of strings")
    trans: list[dict[str, int]] = [{}]
    accept = [False]
    for c in choices:
        if not isinstance(c, str) or not c:
            raise InvalidGrammar(
                f"choices entries must be non-empty strings, got {c!r}"
            )
        cur = 0
        for ch in c:
            nxt = trans[cur].get(ch)
            if nxt is None:
                trans.append({})
                accept.append(False)
                nxt = len(trans) - 1
                trans[cur][ch] = nxt
            cur = nxt
        accept[cur] = True
    return trans, accept


# ---------------------------------------------------------------------------
# JSON schema → regex (canonical JSON, everything regular)
# ---------------------------------------------------------------------------

_REGEX_META = set("\\^$.|?*+()[]{}")


def regex_escape(text: str) -> str:
    return "".join(("\\" + c) if c in _REGEX_META else c for c in text)


# Canonical string body charset: the vocab minus the quote, backslash,
# and ALL control characters below 0x20 (RFC 8259 says those MUST be
# escaped inside a JSON string — excluding them outright means no
# escape sequences, which keeps the automaton small and every emitted
# string loads with strict json.loads unchanged). The controls are
# spelled as literal characters: the grammar parser has no \xNN escape.
_JSON_STRING_CLASS = '[^"\\\\' + "".join(map(chr, range(0x20))) + "]"
_JSON_INT = r"-?(0|[1-9][0-9]*)"
_JSON_NUMBER = _JSON_INT + r"(\.[0-9]+)?"


def schema_to_regex(schema: Any, *, depth: int = 0) -> str:
    """Compile the supported json_schema subset to a regex over
    CANONICAL JSON (``json.dumps(..., separators=(',', ':'))`` — no
    whitespace, properties in declared order). Supported: ``object``
    (properties emitted in declared order; ``required`` defaults to all),
    ``string`` (``minLength``/``maxLength``/``pattern``), ``integer``,
    ``number``, ``boolean``, ``null``, ``enum``/``const``, ``array``
    (``items`` + ``minItems``/``maxItems``). Anything else is a typed
    ``invalid_grammar``."""
    if depth > 8:
        raise InvalidGrammar("json_schema nests deeper than 8 levels")
    if not isinstance(schema, dict):
        raise InvalidGrammar(f"json_schema must be an object, got {schema!r}")
    if "const" in schema:
        return regex_escape(
            json.dumps(schema["const"], separators=(",", ":"))
        )
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise InvalidGrammar("enum must be a non-empty list")
        return "(" + "|".join(
            regex_escape(json.dumps(v, separators=(",", ":")))
            for v in vals
        ) + ")"
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties") or {}
        if not isinstance(props, dict) or not props:
            raise InvalidGrammar(
                "object schemas need non-empty 'properties'"
            )
        required = schema.get("required")
        keep = (props if required is None
                else {k: v for k, v in props.items() if k in required})
        if not keep:
            raise InvalidGrammar("object schema with no required property")
        body = ",".join(
            regex_escape(json.dumps(k) + ":") + schema_to_regex(
                v, depth=depth + 1
            )
            for k, v in keep.items()
        )
        return r"\{" + body + r"\}"
    if t == "string":
        lo = int(schema.get("minLength", 0))
        hi = schema.get("maxLength")
        if schema.get("pattern") is not None:
            return '"' + str(schema["pattern"]) + '"'
        if hi is None:
            body = _JSON_STRING_CLASS + (f"{{{lo},}}" if lo else "*")
        else:
            body = _JSON_STRING_CLASS + f"{{{lo},{int(hi)}}}"
        return '"' + body + '"'
    if t == "integer":
        return _JSON_INT
    if t == "number":
        return _JSON_NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items") or {"type": "integer"},
                               depth=depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        item = "(" + item + ")"
        if lo == 0:
            inner = (f"({item}(,{item})*)?" if hi is None
                     else f"({item}(,{item}){{0,{max(0, int(hi) - 1)}}})?")
        else:
            tail = (f"(,{item})*" if hi is None
                    else f"(,{item}){{{lo - 1},{max(0, int(hi) - 1)}}}")
            inner = item + tail
        return r"\[" + inner + r"\]"
    raise InvalidGrammar(f"unsupported json_schema type {t!r}")


# ---------------------------------------------------------------------------
# tokenizer closure → CompiledProgram
# ---------------------------------------------------------------------------

class CompiledProgram:
    """One constraint compiled to token-level tables (host numpy; the
    :class:`ProgramPool` materializes them on device):

    - ``allow [n_states, vocab] bool`` — token legal from this state
    - ``next  [n_states, vocab] int32`` — LOCAL successor state (0 where
      disallowed — never followed, the mask forbids it first)
    - ``accept [n_states] bool`` — the emitted-so-far text matches
    - ``complete [n_states] bool`` — accepting with no way to extend:
      the scheduler retires the slot here (finish_reason
      ``grammar_complete``)

    State 0 is the start. ``digest`` keys the LRU caches (spec + eos +
    vocab fingerprint)."""

    def __init__(self, *, allow: np.ndarray, nxt: np.ndarray,
                 accept: np.ndarray, complete: np.ndarray, digest: str,
                 kind: str, spec: Any) -> None:
        self.allow = allow
        self.next = nxt
        self.accept = accept
        self.complete = complete
        self.digest = digest
        self.kind = kind
        self.spec = spec
        self.n_states = int(allow.shape[0])

    def walk(self, state: int, token: int) -> int:
        """Host-side FSM advance for ONE delivered token (the scheduler
        re-derives per-request state from emitted tokens — replay after
        a crash reconstructs it for free)."""
        return int(self.next[state, token])

    def describe(self) -> dict:
        return {"kind": self.kind, "digest": self.digest[:12],
                "n_states": self.n_states}


def _token_closure(
    trans: list[dict[str, int]], accept: list[bool],
    vocab: Sequence[str], eos_id: int | None,
) -> CompiledProgram:
    """Walk every vocab token's string through the char DFA from every
    state → token-level ``allow``/``next``; then prune token-level-dead
    transitions (a char path no whole token realizes) so generation can
    always either extend or finish."""
    n, v = len(trans), len(vocab)
    allow = np.zeros((n, v), np.bool_)
    nxt = np.zeros((n, v), np.int32)
    for tid, text in enumerate(vocab):
        if not text:
            continue  # empty tokens would advance nothing, forever
        for s in range(n):
            cur = s
            for ch in text:
                cur = trans[cur].get(ch, -1)
                if cur < 0:
                    break
            if cur >= 0:
                allow[s, tid] = True
                nxt[s, tid] = cur
    acc = np.asarray(accept, np.bool_)
    # Token-level liveness: a state must reach an accept state via
    # TOKEN edges (or be accepting itself); edges into token-dead
    # states are removed. One pass suffices: surviving states keep the
    # very edge that made them live.
    live = set(np.flatnonzero(acc).tolist())
    changed = True
    while changed:
        changed = False
        for s in range(n):
            if s in live:
                continue
            dests = nxt[s][allow[s]]
            if any(int(d) in live for d in dests):
                live.add(s)
                changed = True
    if 0 not in live:
        raise InvalidGrammar(
            "constraint cannot be completed with this vocabulary"
        )
    for s in range(n):
        for tid in np.flatnonzero(allow[s]):
            if int(nxt[s, tid]) not in live:
                allow[s, tid] = False
                nxt[s, tid] = 0
    if eos_id is not None and 0 <= eos_id < v:
        # eos is legal exactly at accepting states (and self-loops —
        # the scheduler retires on it before another step runs).
        allow[:, eos_id] = acc
        nxt[:, eos_id] = np.where(acc, np.arange(n), 0)
    # complete = accepting with no non-eos continuation: retire here.
    cont = allow.copy()
    if eos_id is not None and 0 <= eos_id < v:
        cont[:, eos_id] = False
    complete = acc & ~cont.any(axis=1)
    return CompiledProgram(
        allow=allow, nxt=nxt, accept=acc, complete=complete,
        digest="", kind="", spec=None,
    )


# ---------------------------------------------------------------------------
# the compiler (LRU, off the device lock)
# ---------------------------------------------------------------------------

_SPEC_KINDS = ("json_schema", "regex", "choices")


def default_vocab(vocab_size: int) -> list[str]:
    """Token id → string for toy/byte models: identity ``chr(i)`` — the
    mapping serve_lm and the tests use when no tokenizer exists. Real
    deployments pass their tokenizer's id→piece table instead."""
    return [chr(i) for i in range(vocab_size)]


def detokenize(vocab: Sequence[str], ids: Sequence[int]) -> str:
    return "".join(vocab[int(i)] for i in ids)


class ConstraintCompiler:
    """spec dict → :class:`CompiledProgram`, LRU-cached by digest.

    Thread-safe and device-free: the scheduler calls :meth:`compile`
    at ENQUEUE time on HTTP threads, off the device lock, so a cold
    compile costs queue latency only. All failures raise the typed
    :class:`InvalidGrammar` (400, not retryable)."""

    def __init__(self, vocab: Sequence[str], *,
                 max_states: int = MAX_DFA_STATES,
                 cache_programs: int = 64) -> None:
        self.vocab = [str(t) for t in vocab]
        self.max_states = int(max_states)
        self.cache_programs = max(1, int(cache_programs))
        self.alphabet = sorted({ch for t in self.vocab for ch in t})
        self._fingerprint = hashlib.sha1(
            "\x00".join(self.vocab).encode()
        ).hexdigest()[:16]
        # Single-char reverse map for stop-string encoding (first id
        # wins, matching detokenize round-trips for identity vocabs).
        self._char_token: dict[str, int] = {}
        for tid, t in enumerate(self.vocab):
            if len(t) == 1 and t not in self._char_token:
                self._char_token[t] = tid
        self._lock = threading.Lock()
        self._cache: OrderedDict[str, CompiledProgram] = OrderedDict()
        self.compiles = 0
        self.cache_hits = 0

    def digest_of(self, spec: Any, eos_id: int | None) -> str:
        blob = json.dumps({"spec": spec, "eos": eos_id,
                           "vocab": self._fingerprint},
                          sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()

    def compile(self, spec: dict, *,
                eos_id: int | None = None) -> CompiledProgram:
        if not isinstance(spec, dict):
            raise InvalidGrammar(
                f"constraint spec must be an object, got {type(spec).__name__}"
            )
        kinds = [k for k in _SPEC_KINDS if spec.get(k) is not None]
        if len(kinds) != 1:
            raise InvalidGrammar(
                "constraint spec needs exactly one of "
                f"{'/'.join(_SPEC_KINDS)}, got {kinds or 'none'}"
            )
        kind = kinds[0]
        digest = self.digest_of({kind: spec[kind]}, eos_id)
        with self._lock:
            prog = self._cache.get(digest)
            if prog is not None:
                self._cache.move_to_end(digest)
                self.cache_hits += 1
                return prog
        prog = self._compile_cold(kind, spec[kind], eos_id, digest)
        with self._lock:
            self.compiles += 1
            self._cache[digest] = prog
            self._cache.move_to_end(digest)
            while len(self._cache) > self.cache_programs:
                self._cache.popitem(last=False)
                SERVE_CONSTRAIN_EVICTIONS.inc(tier="cache")
        return prog

    def _compile_cold(self, kind: str, body: Any, eos_id: int | None,
                      digest: str) -> CompiledProgram:
        if kind == "choices":
            trans, accept = _choices_dfa(body)
            if len(trans) > self.max_states:
                raise InvalidGrammar(
                    f"choices trie exceeds {self.max_states} states"
                )
        else:
            pattern = (body if kind == "regex"
                       else schema_to_regex(body))
            if not isinstance(pattern, str) or not pattern:
                raise InvalidGrammar("regex must be a non-empty string")
            trans, accept = _char_dfa(pattern, self.alphabet,
                                      self.max_states)
        prog = _token_closure(trans, accept, self.vocab, eos_id)
        prog.digest = digest
        prog.kind = kind
        prog.spec = {kind: body}
        return prog

    def encode_stop(self, stop: Any) -> tuple[tuple[int, ...], ...]:
        """Stop entries → token-id sequences: int lists pass through;
        strings encode char-by-char via the single-char reverse map (the
        identity-vocab case — real tokenizers pass id lists)."""
        if stop is None:
            return ()
        if not isinstance(stop, (list, tuple)) or not stop:
            raise InvalidGrammar("stop must be a non-empty list")
        out = []
        for entry in stop:
            if isinstance(entry, str):
                if not entry:
                    raise InvalidGrammar("empty stop string")
                try:
                    out.append(tuple(self._char_token[c] for c in entry))
                except KeyError as exc:
                    raise InvalidGrammar(
                        f"stop string {entry!r} has no token for "
                        f"character {exc.args[0]!r}"
                    ) from None
            elif isinstance(entry, (list, tuple)) and entry and all(
                    isinstance(t, int) and not isinstance(t, bool)
                    for t in entry):
                out.append(tuple(int(t) for t in entry))
            else:
                raise InvalidGrammar(
                    f"stop entries must be strings or token-id lists, "
                    f"got {entry!r}"
                )
        return tuple(out)

    def debug(self) -> dict:
        with self._lock:
            return {
                "cached_programs": len(self._cache),
                "cache_limit": self.cache_programs,
                "compiles": self.compiles,
                "cache_hits": self.cache_hits,
                "alphabet": len(self.alphabet),
            }


# ---------------------------------------------------------------------------
# stop sequences (host-side, bounded tail buffer)
# ---------------------------------------------------------------------------

def max_stop_len(stops: Sequence[Sequence[int]]) -> int:
    return max((len(s) for s in stops), default=0)


def match_stop(out: Sequence[int],
               stops: Sequence[Sequence[int]]) -> int:
    """Incremental check after each delivered token: does any stop
    sequence end EXACTLY at the current tail? Returns the matched
    length (trim that many) or 0. Only the last ``max_stop_len``
    tokens are examined — the bounded tail buffer."""
    for s in stops:
        k = len(s)
        if k and len(out) >= k and tuple(out[-k:]) == tuple(s):
            return k
    return 0


def apply_stop(tokens: Sequence[int],
               stops: Sequence[Sequence[int]]) -> list[int]:
    """Post-hoc solo semantics: cut at the FIRST position where any
    stop sequence completes, excluding the stop tokens themselves. The
    incremental :func:`match_stop` loop produces exactly this — pinned
    by tests so the two can never drift."""
    toks = list(tokens)
    for j in range(len(toks)):
        for s in stops:
            k = len(s)
            if k and j + 1 >= k and tuple(toks[j + 1 - k:j + 1]) == tuple(s):
                return toks[:j + 1 - k]
    return toks



# ---------------------------------------------------------------------------
# the paged constraint pool (device tables, programs as row ranges)
# ---------------------------------------------------------------------------

class ProgramPool:
    """Fixed-shape tables on ``device`` that every decode step reads as
    data:

    - ``allow_pool [rows, vocab] bool`` — True = token legal
    - ``next_pool  [rows, vocab] int32`` — ABSOLUTE successor row

    Row 0 is the always-allow garbage program (all-True mask, next
    always 0): unconstrained lanes gather row 0, add +0.0, and keep their
    solo law. A program binds into a contiguous row range (its local
    states offset by the base row) with a refcount; refcount-0 programs
    stay resident for reuse and evict LRU when a bind needs their rows.
    A bind writes its rows in place.

    Single-threaded by design: bind/release run on the scheduler's
    serving loop (join/retire), exactly like the block allocator."""

    def __init__(self, rows: int, vocab_size: int, *, device=None) -> None:
        if rows < 2:
            raise ValueError(f"constrain_rows={rows} must be >= 2")
        self.rows = int(rows)
        self.vocab_size = int(vocab_size)
        self.allow_pool = torch.ones((self.rows, self.vocab_size),
                                     dtype=torch.bool, device=device)
        self.next_pool = torch.zeros((self.rows, self.vocab_size),
                                     dtype=torch.int32, device=device)
        # digest -> [base, n_states, refs, last_used_tick]
        self._resident: dict[str, list[int]] = {}
        self._free: list[tuple[int, int]] = [(1, self.rows - 1)]
        self._tick = 0
        self.evictions = 0
        self.binds = 0

    # -- allocation -----------------------------------------------------

    def _alloc_range(self, n: int) -> int | None:
        for i, (start, length) in enumerate(self._free):
            if length >= n:
                if length == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (start + n, length - n)
                return start
        return None

    def _free_range(self, start: int, n: int) -> None:
        self._free.append((start, n))
        self._free.sort()
        merged: list[tuple[int, int]] = []
        for s, ln in self._free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((s, ln))
        self._free = merged

    def _evict_one(self) -> bool:
        victims = [(ent[3], dig) for dig, ent in self._resident.items()
                   if ent[2] == 0]
        if not victims:
            return False
        _, dig = min(victims)
        base, n, _, _ = self._resident.pop(dig)
        self._free_range(base, n)
        self.evictions += 1
        SERVE_CONSTRAIN_EVICTIONS.inc(tier="pool")
        SERVE_CONSTRAIN_PROGRAMS.set(len(self._resident))
        return True

    # -- the public surface --------------------------------------------

    def bind(self, prog: CompiledProgram) -> int | None:
        """Make ``prog`` resident and take a reference; returns its base
        row (slot fsm row = base + local state), or None when every
        resident program is still referenced and nothing can evict —
        the caller requeues, exactly like KV-block exhaustion."""
        self._tick += 1
        ent = self._resident.get(prog.digest)
        if ent is not None:
            ent[2] += 1
            ent[3] = self._tick
            self.binds += 1
            return ent[0]
        n = prog.n_states
        if n > self.rows - 1:
            raise InvalidGrammar(
                f"program needs {n} rows; the constraint pool has "
                f"{self.rows - 1} (raise constrain_rows)"
            )
        base = self._alloc_range(n)
        while base is None:
            if not self._evict_one():
                return None
            base = self._alloc_range(n)
        # Absolute successor rows; disallowed entries point at the
        # garbage row (never followed — the mask forbids the token).
        nxt_abs = np.where(prog.allow, prog.next.astype(np.int64) + base,
                           0).astype(np.int32)
        dev = self.allow_pool.device
        self.allow_pool[base:base + n] = torch.from_numpy(prog.allow).to(dev)
        self.next_pool[base:base + n] = torch.from_numpy(nxt_abs).to(dev)
        self._resident[prog.digest] = [base, n, 1, self._tick]
        self.binds += 1
        SERVE_CONSTRAIN_PROGRAMS.set(len(self._resident))
        return base

    def release(self, digest: str) -> None:
        ent = self._resident.get(digest)
        if ent is not None and ent[2] > 0:
            ent[2] -= 1

    def debug(self) -> dict:
        used = sum(ent[1] for ent in self._resident.values())
        return {
            "rows": self.rows,
            "rows_used": used + 1,  # + the garbage row
            "programs": len(self._resident),
            "live_refs": sum(ent[2] for ent in self._resident.values()),
            "evictions": self.evictions,
            "binds": self.binds,
        }


# ---------------------------------------------------------------------------
# the solo oracle
# ---------------------------------------------------------------------------

def oracle_tables(program: CompiledProgram, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The oracle's ``(allow [n+1, V] bool, next [n+1, V] int32)``: the
    program's local tables plus an always-allow free state ``n`` that
    every disallowed transition leads to — the pool's row-0 convention, so
    engine and oracle agree for the whole stream, not just up to
    completion (a completed grammar's masked argmax picks garbage)."""
    n_states, vocab = program.allow.shape
    free = n_states
    allow = np.concatenate([program.allow, np.ones((1, vocab), np.bool_)])
    nxt = np.where(program.allow, program.next.astype(np.int32),
                   free).astype(np.int32)
    nxt = np.concatenate([nxt, np.full((1, vocab), free, np.int32)])
    return (torch.as_tensor(allow, device=device),
            torch.as_tensor(nxt, device=device))


def constrained_generate(cfg: Any, params: Any, prompt: Any,
                         num_steps: int, *, program: CompiledProgram,
                         temperature: float = 0.0,
                         top_p: float | None = None, rng: Any = None,
                         device=None) -> torch.Tensor:
    """``generate`` with the constraint walked inline: the oracle every
    constrained engine slot is held to. Per step the logits take the
    additive mask of the CURRENT state's allow row before temperature/
    top_p/argmax — the engine's op order — and the state advances through
    the sampled token. ``[1, L]`` prompts (the per-slot shape); returns
    ``[1, num_steps]`` int32 on ``device`` (default the card).
    ``params`` is a flax-layout tree or a loaded decode-mode model, as
    ``generate`` takes."""
    from tf_operator_tpu_torch.models.transformer import (
        _decode_model,
        _nucleus_filter,
        _prefill,
    )
    from tf_operator_tpu_torch.random import categorical, split

    if prompt.shape[0] != 1:
        raise ValueError("constrained_generate serves [1, L] prompts")
    if prompt.shape[1] + num_steps > cfg.max_seq_len:
        raise ValueError("prompt + steps exceeds max_seq_len")
    if temperature > 0 and rng is None:
        raise ValueError("temperature > 0 needs an rng key")
    if top_p is not None and temperature <= 0:
        raise ValueError("top_p requires temperature > 0")
    model = _decode_model(cfg, params, device)
    dev = model.device
    allow_t, next_t = oracle_tables(program, dev)
    with torch.no_grad():
        cache, logits = _prefill(model, torch.as_tensor(prompt, device=dev))
        if temperature > 0:
            keys = split(torch.as_tensor(rng, dtype=torch.int64,
                                         device=dev), num_steps)
            temp = torch.tensor(float(temperature), dtype=torch.float32,
                                device=dev)
        state = torch.zeros((), dtype=torch.int64, device=dev)
        toks = []
        for i in range(num_steps):
            masked = logits + torch.where(allow_t[state], 0.0, NEG_MASK)
            if temperature > 0:
                scaled = masked / temp
                if top_p is not None:
                    scaled = _nucleus_filter(scaled, float(top_p))
                tok = categorical(keys[i], scaled)
            else:
                tok = masked.argmax(-1)
            tok = tok.to(torch.int32)
            state = next_t[state, tok[0].long()].long()
            toks.append(tok)
            if i + 1 < num_steps:
                logits = model(tok[:, None], cache)[:, 0]
        return torch.stack(toks, dim=1)


def walk_tokens(program: CompiledProgram, tokens: Sequence[int],
                state: int = 0) -> tuple[int, int | None]:
    """Walk delivered tokens through the program from ``state``;
    returns (final state, index AFTER which the grammar completed —
    None if it never did). The scheduler's trim rule and the tests'
    expected-output rule share this one walker."""
    done_at = None
    for i, tok in enumerate(tokens):
        state = program.walk(state, int(tok))
        if done_at is None and bool(program.complete[state]):
            done_at = i
    return state, done_at
