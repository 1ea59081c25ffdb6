"""Modes, one file each, found by a traffic mix's ``mode``: each defines
``run(spec, seed, seconds, trace_on, device, started)`` (see
:mod:`.train`)."""
