"""Docs-vs-validator consistency.

Round-3 review found docs/API.md documenting ``ordering='spectral'``,
which the NTTConfig validator rejects (config.py __post_init__ accepts
only natural/bitrev/reference). This pins the API reference's enum
bullets to the validator's accepted sets so they cannot drift apart
again.
"""

import pathlib
import re

import pytest

from ntt_aie.config import NTTConfig
from ntt_aie.fields import P_469762049

API_MD = pathlib.Path(__file__).resolve().parent.parent / "docs" / "API.md"

ORDERINGS = {"natural", "bitrev", "reference"}
REDUCTIONS = {"auto", "barrett", "montgomery", "harvey", "harvey4",
              "goldilocks"}


def _bullet(name: str) -> str:
    """The API.md bullet documenting config attribute `name` (from the
    `- \\`name\\`:` line to the next top-level `- ` bullet)."""
    text = API_MD.read_text()
    m = re.search(rf"^  - `{name}`:.*?(?=^  - `|^\n## )", text,
                  re.MULTILINE | re.DOTALL)
    assert m, f"API.md has no `{name}` bullet"
    return m.group(0)


def _quoted_values(block: str) -> set:
    return set(re.findall(r"`?'(\w+)'`?", block))


def test_validator_accepts_exactly_the_documented_orderings():
    documented = _quoted_values(_bullet("ordering"))
    assert documented == ORDERINGS
    for o in documented:
        NTTConfig(field=P_469762049, log_n=8, ordering=o)  # must not raise
    with pytest.raises(ValueError):
        NTTConfig(field=P_469762049, log_n=8, ordering="spectral")


def test_documented_reductions_are_all_accepted():
    documented = _quoted_values(_bullet("reduction"))
    assert documented <= REDUCTIONS
    assert "auto" in documented
    for r in documented - {"goldilocks"}:
        NTTConfig(field=P_469762049, log_n=8, reduction=r)  # must not raise
