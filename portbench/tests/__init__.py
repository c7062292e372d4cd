"""Tests of the benchmark's harness: its manifest, files found by name,
rooflines, trace reader, reference and faults."""
