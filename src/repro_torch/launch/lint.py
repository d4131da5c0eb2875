"""Launch alias for the op-trace invariant linter.

``python -m repro_torch.launch.lint`` ≡ ``python -m repro_torch.analysis``
— kept so the launch/ namespace lists every operational entry point
(train, serve, dryrun, lint). See :mod:`repro_torch.analysis` for the
invariant contract and the rule catalog.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.lint [--smoke] \
      [--device meta|cpu|cuda] [--json report.json]
"""
from repro_torch.analysis.lint import main

if __name__ == "__main__":
    raise SystemExit(main())
