"""The benchmark's harness: finds a cell's files by name (manifest), makes
its inputs from the seed (scene), drives the program's entry point
(entries/), reads the device trace (trace) and judges the outputs against
the plain reference (check)."""
