"""Multi-tenant schema estate: registry + tape linker.

``registry.py`` owns compiled-schema versions per endpoint id and builds
one batched executor per link group; ``linker.py`` relocates and
concatenates member location tapes into linked tapes so a mixed-endpoint
batch validates in few batched launches (DESIGN.md §8, §14).
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
from .registry import (
    AdmitCounts,
    LinkGroup,
    RegistrationError,
    SchemaEntry,
    SchemaRegistry,
    SchemaStats,
)

__all__ = [
    "LinkedTape",
    "TapeSegment",
    "link_tapes",
    "segment_tape",
    "group_signature",
    "signature_label",
    "pow2_class",
    "AdmitCounts",
    "LinkGroup",
    "RegistrationError",
    "SchemaEntry",
    "SchemaRegistry",
    "SchemaStats",
]
