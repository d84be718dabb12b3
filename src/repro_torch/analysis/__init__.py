"""Static analysis over the traced aten graph (port of ``repro.analysis``):
it prunes, cross-checks and guards the AD scrutiny.

- :func:`analyze_static` — static element criticality (with int/bool
  dataflow), the same report interface as the AD engines.
- :func:`verify_soundness` / :func:`soundness_checker` — the checked
  invariant AD-critical ⊆ static-critical, with graph provenance on a
  violation.
- :func:`lint_step` / :func:`lint_file` / :func:`lint_paths` — the
  checkpoint-safety linter (``python -m repro_torch.analysis.lint``).
"""

from repro_torch.analysis.lint import (Finding, findings_json, lint_file,
                                      lint_paths, lint_step)
from repro_torch.analysis.soundness import (SoundnessError, SoundnessResult,
                                            Violation, soundness_checker,
                                            verify_soundness)
from repro_torch.analysis.static import (ReaderRecord, StaticReport,
                                         analyze_static)

__all__ = ["Finding", "ReaderRecord", "SoundnessError", "SoundnessResult",
           "StaticReport", "Violation", "analyze_static", "findings_json",
           "lint_file", "lint_paths", "lint_step", "soundness_checker",
           "verify_soundness"]
