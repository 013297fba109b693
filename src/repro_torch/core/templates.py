"""Portable template stores (paper §III-E).

"In practice, logging statements of a system evolve slowly. Therefore,
ISE could be considered as a one-off procedure for a specific system...
we could extract structures of new logs from the system through matching
instead of running the ISE."

A ``TemplateStore`` holds templates as token STRINGS (None = wildcard),
so it is independent of any one archive's vocab. ``extract_templates``
runs ISE once; ``codec.compress(..., template_store=...)`` (via
``LogzipConfig.template_store``) then matches new corpora against the
stored set — EventIDs are stable across archives/streams, which is what
downstream consumers (anomaly detection, dashboards) key on.

The store is *incremental*: it is append-only and ``add`` is
get-or-assign, so a ``StreamingCompressor`` session can grow one store
across chunks (DESIGN.md §9) — a template keeps the global id it was
first assigned, forever. Existing ids never move.
"""

from __future__ import annotations

import json
import re

import numpy as np

from .ise import ISEConfig, ISEResult, iterative_structure_extraction
from .tokenizer import DEFAULT_DELIMITERS, STAR_ID, LogFormat, Vocab, tokenize


def template_regex(template, delimiters: str = DEFAULT_DELIMITERS) -> str:
    """Compile a template (token strings, None = wildcard) to an anchored
    regex over message *content* with the literal tokens escaped in place.

    The pattern matches exactly the set of contents a line of this
    template can have: literal tokens verbatim, each wildcard one-or-more
    tokens (non-delimiter runs) with interior delimiter runs, and
    arbitrary delimiter runs in the gaps (leading/trailing possibly
    empty). Used by the query planner (DESIGN.md §11) and by ``grep
    --explain`` so users can re-run a pushed-down template against raw
    logs."""
    d = re.escape(delimiters)
    D, T = f"[{d}]", f"[^{d}]"
    parts = [f"^{D}*"]
    for j, tok in enumerate(template):
        if j:
            parts.append(f"{D}+")
        if tok is None:
            parts.append(f"{T}+(?:{D}+{T}+)*")
        else:
            parts.append(re.escape(tok))
    parts.append(f"{D}*$")
    return "".join(parts)


def compile_template_regex(template, delimiters: str = DEFAULT_DELIMITERS) -> re.Pattern:
    return re.compile(template_regex(template, delimiters))


class TemplateStore:
    def __init__(self, templates: list[tuple] = ()):
        # each template: tuple of token strings, None = wildcard
        self.templates = [tuple(t) for t in templates]
        self._index = {t: i for i, t in enumerate(self.templates)}

    def __len__(self):
        return len(self.templates)

    def add(self, template) -> int:
        """Get-or-assign the global id of ``template`` (append-only)."""
        tup = tuple(template)
        i = self._index.get(tup)
        if i is None:
            i = len(self.templates)
            self._index[tup] = i
            self.templates.append(tup)
        return i

    def extend_from_ise(self, result: ISEResult, vocab: Vocab) -> list[int]:
        """Fold freshly-discovered templates in; -> global id per local id."""
        out = []
        for tpl in result.templates:
            out.append(self.add(
                tuple(None if int(t) == STAR_ID else vocab.token(int(t)) for t in tpl)))
        return out

    @classmethod
    def from_reference(cls, templates) -> "TemplateStore":
        """The carried state of paper §III-E: a store built by the JAX
        package (its ``TemplateStore.templates``, a list of tuples of token
        strings with None for a wildcard) as a store of this package. Ids
        keep their order, so EventIDs stay stable across the two."""
        out = []
        for tpl in templates:
            tup = tuple(tpl)
            if not all(t is None or isinstance(t, str) for t in tup):
                raise TypeError(f"template tokens must be str or None: {tup!r}")
            out.append(tup)
        return cls(out)

    @classmethod
    def from_ise(cls, result: ISEResult, vocab: Vocab) -> "TemplateStore":
        out = []
        for tpl in result.templates:
            out.append(tuple(None if int(t) == STAR_ID else vocab.token(int(t)) for t in tpl))
        return cls(out)

    def to_id_arrays(self, vocab: Vocab) -> list[np.ndarray]:
        """Map to a given archive's vocab. Literals absent from the corpus
        keep PAD id 0 -> the template simply cannot match there (correct:
        that literal does not occur)."""
        out = []
        for tpl in self.templates:
            out.append(np.array(
                [STAR_ID if t is None else vocab.lookup(t) for t in tpl], np.int32
            ))
        return out

    def as_strings(self) -> list[str]:
        return [" ".join("<*>" if t is None else t for t in tpl) for tpl in self.templates]

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump([[t for t in tpl] for tpl in self.templates], f)

    @classmethod
    def load(cls, path: str) -> "TemplateStore":
        with open(path, encoding="utf-8") as f:
            return cls([tuple(t) for t in json.load(f)])


def extract_templates(lines: list[str], format: str | None = None,
                      ise: ISEConfig | None = None, *,
                      device: str = "cuda") -> TemplateStore:
    """One-off ISE over a reference corpus -> reusable TemplateStore."""
    if format:
        fmt = LogFormat(format)
        cols, ok, _ = fmt.parse(lines)
        contents = cols[fmt.content_field]
        levels = cols.get("Level")
        comps = cols.get("Component")
    else:
        contents, levels, comps = list(lines), None, None
    vocab = Vocab()
    toks = [tokenize(c)[0] for c in contents]
    ids, lens = vocab.encode_batch(toks, 128)

    def fact(vals):
        if vals is None:
            return None
        seen: dict = {}
        return np.array([seen.setdefault(v, len(seen)) for v in vals], np.int64)

    res = iterative_structure_extraction(ids, lens, fact(levels), fact(comps),
                                         len(vocab), ise or ISEConfig(), device=device)
    return TemplateStore.from_ise(res, vocab)
