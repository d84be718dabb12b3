"""Static analysis over the traced aten graph (port of ``repro.analysis``):
it prunes, cross-checks and guards the AD scrutiny.

- :func:`analyze_static` — static element criticality (with int/bool
  dataflow), the same report interface as the AD engines.
- :func:`verify_soundness` / :func:`soundness_checker` — the checked
  invariant AD-critical ⊆ static-critical, with graph provenance on a
  violation.

The reference's checkpoint-safety linter (``repro.analysis.lint``) is not
ported yet (ROADMAP Queue 1, item 8b).
"""

from repro_torch.analysis.soundness import (SoundnessError, SoundnessResult,
                                            Violation, soundness_checker,
                                            verify_soundness)
from repro_torch.analysis.static import (ReaderRecord, StaticReport,
                                         analyze_static)

__all__ = ["ReaderRecord", "SoundnessError", "SoundnessResult",
           "StaticReport", "Violation", "analyze_static",
           "soundness_checker", "verify_soundness"]
