"""Test/validation utilities shipped with the engine (not test-only code:
the crash-loop harness is a user-runnable durability checker)."""
