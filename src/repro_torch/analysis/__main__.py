"""``python -m repro_torch.analysis`` — the op-trace invariant linter CLI."""
from repro_torch.analysis.lint import main

if __name__ == "__main__":
    raise SystemExit(main())
