"""Interaction-text -> per-person individual-text decomposition; this
package's copy of ``mixermdm_tpu/eval/decompose.py``
(``decompose_interaction_text``, ``heuristic_text_decomposer``,
``get_decomposer`` and their helpers; pure ``re``).

The reference pipes every interaction caption through an LLM with a
one-shot prompt ("Having the description of an interaction, extract
individual descriptions for the motions of each individual",
reference src/evaluation/datasets.py:32-96), which is unavailable offline.
This is a deterministic linguistic decomposer for the same job: clause-split
the caption, classify each clause's grammatical subject as person 1 /
person 2 / both, and emit one description per person with the subject
normalised to "one person" and partner mentions normalised to "the other
person".  The inference CLI uses it when the individual prompts are left
out, the evaluation datasets where a dataset carries none, and
``eval-mixermdm --decompose`` through :func:`get_decomposer`.
"""

from __future__ import annotations

import re
from typing import List, Tuple

# Subject markers, longest-first so e.g. "the other person" wins over "the
# other".  InterHuman captions overwhelmingly use these openings.
_P1_SUBJECTS = (
    "the first person", "the first one", "the first individual", "person 1",
    "person one", "one person", "one of them", "one man", "one woman",
    "a person", "someone", "somebody",
)
_P2_SUBJECTS = (
    "the other person", "the other one", "the other individual", "person 2",
    "person two", "the second person", "the second one", "the opponent",
    "the partner", "another person", "the other",
)
_BOTH_SUBJECTS = (
    "two people", "two persons", "two individuals", "both people",
    "both persons", "both of them", "the two", "both", "they",
)
# Pronoun subjects continue the PREVIOUS clause's subject.
_CONT_SUBJECTS = ("he", "she", "then he", "then she")

# Clause delimiters, tried in order.  "and" alone is NOT a delimiter — a
# bare "and" usually coordinates verbs of one subject ("raises a hand and
# waves"); clauses only split on "and" when followed by a subject marker
# (handled by _SUBJECT_AND below).
_DELIMS = re.compile(
    r",?\s+(?:and\s+then|then|while|whilst|meanwhile|as|whereupon|before|"
    r"after)\s+|;\s+|\.\s+"
)
_ALL_SUBJECTS = tuple(
    sorted(_P1_SUBJECTS + _P2_SUBJECTS + _BOTH_SUBJECTS, key=len, reverse=True)
)
_SUBJECT_AND = re.compile(
    r",?\s+and\s+(?=(?:" + "|".join(re.escape(s) for s in _ALL_SUBJECTS) + r")\b)",
    re.IGNORECASE,
)
# A bare comma also starts a new clause when (and only when) a subject
# marker follows: "one person swings a bat, the other person ducks".
_SUBJECT_COMMA = re.compile(
    r",\s+(?=(?:" + "|".join(re.escape(s) for s in _ALL_SUBJECTS) + r")\b)",
    re.IGNORECASE,
)
_WHO = re.compile(r",\s+who\s+")
# Scene-setting prefix: "in an intense boxing match, ..." (reference's own
# one-shot example carries one).
_SCENE = re.compile(r"^(?:in|during|at|amid|amidst)\b[^,]{0,60},\s+", re.IGNORECASE)


def _classify(clause: str) -> Tuple[str, str]:
    """-> (who, remainder): who in {'p1','p2','both','cont',''}; remainder is
    the clause with the subject phrase stripped."""
    low = clause.lower()
    for subjects, who in ((_P2_SUBJECTS, "p2"), (_P1_SUBJECTS, "p1"),
                          (_BOTH_SUBJECTS, "both")):
        for s in sorted(subjects, key=len, reverse=True):
            if low.startswith(s + " "):
                return who, clause[len(s):].strip()
    for s in _CONT_SUBJECTS:
        if low.startswith(s + " "):
            return "cont", clause[len(s):].strip()
    return "", clause


def _normalise_partner(pred: str) -> str:
    """Rewrite partner mentions inside a predicate to 'the other person'."""
    pred = re.sub(r"\beach other'?s?\b", "the other person", pred)
    pred = re.sub(
        r"\b(?:the opponent|the other person|the other one|the partner|"
        r"the other|the second person|the first person|him|her|them)\b",
        "the other person", pred)
    # Collapse accidental doubles from overlapping patterns.
    return re.sub(r"(the other person)(\s+\1)+", r"\1", pred)


def decompose_interaction_text(text: str) -> Tuple[str, str]:
    """One interaction caption -> (person-1 text, person-2 text).

    Falls back to the identity (both persons get the caption) when no
    person-specific clause is found — the same behaviour as the reference's
    non-LLM path.
    """
    body = _SCENE.sub("", text.strip().rstrip("."))
    # Relative clause ", who ..." describes the nearest mentioned person —
    # in practice the clause OBJECT, i.e. the opposite of the current
    # subject; promoting it to a sentence break makes it its own clause so
    # the classifier can flip it.
    body = _WHO.sub(". who ", body)
    parts: List[str] = []
    for chunk in _DELIMS.split(body):
        for piece in _SUBJECT_AND.split(chunk) if chunk else ():
            parts.extend(p for p in _SUBJECT_COMMA.split(piece) if p)

    assigned: List[Tuple[str, str]] = []  # (who, predicate)
    last_who = ""
    for clause in parts:
        clause = clause.strip().strip(",")
        if not clause:
            continue
        who, pred = _classify(clause)
        if clause.lower().startswith("who "):
            # flipped relative clause: belongs to the other person
            who = {"p1": "p2", "p2": "p1"}.get(last_who, "both")
            pred = clause[4:].strip()
        elif who == "cont":
            who = last_who or "both"
        elif who == "":
            # No recognisable subject: the predicate continues the previous
            # clause's subject (verb coordination split by a delimiter).
            who = last_who or "both"
            pred = clause
        last_who = who if who in ("p1", "p2") else last_who
        assigned.append((who, pred))

    if not any(w in ("p1", "p2") for w, _ in assigned):
        return text, text  # identity fallback — nothing person-specific

    def render(who_key: str) -> str:
        preds = [
            _normalise_partner(p)
            for w, p in assigned
            if w == who_key or w == "both"
        ]
        if not preds:
            return text
        return ("one person " + ", then ".join(preds)).strip() + "."

    return render("p1"), render("p2")


def heuristic_text_decomposer(interaction_texts: List[str]):
    """Batch hook matching the ``text_decomposer`` callable signature of the
    evaluation datasets: list of captions -> (list_t1, list_t2)."""
    pairs = [decompose_interaction_text(t) for t in interaction_texts]
    return [a for a, _ in pairs], [b for _, b in pairs]


def get_decomposer(name: str):
    """The evaluation CLI's ``--decompose``: "identity" (both persons get
    the interaction text, the reference's path without its LLM splitter) or
    "heuristic" (:func:`heuristic_text_decomposer`)."""
    if name == "identity":
        from .datasets import default_text_decomposer

        return default_text_decomposer
    if name == "heuristic":
        return heuristic_text_decomposer
    raise ValueError(f"unknown decomposer {name!r}")
