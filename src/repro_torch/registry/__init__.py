"""Multi-tenant schema estate: the tape linker and the gateway presets.

``linker.py`` relocates and concatenates member location tapes into one
linked tape so a mixed-endpoint batch validates in one batched launch
(DESIGN.md §8).  The registry itself is not ported yet.
"""

from .linker import (
    LinkedTape,
    TapeSegment,
    group_signature,
    link_tapes,
    pow2_class,
    segment_tape,
    signature_label,
)

__all__ = [
    "LinkedTape",
    "TapeSegment",
    "link_tapes",
    "segment_tape",
    "group_signature",
    "signature_label",
    "pow2_class",
]
