"""The general machinery of the port's benchmark: manifest and files found
by name (``manifest``), seeded inputs (``data``), the traffic generator
(``traffic``), the program under test (``program``), the two kinds of cell
(``train``, ``serve``), the trace reader (``trace``), the frozen kernel
families, FLOP counts and peaks (``families``, ``counts``, ``peaks``) and
the comparisons that decide ``correct`` (``compare``).

Nothing here imports ``zigp_tpu_torch`` at module level: ``program`` does,
inside its functions, so the harness's own tests import every module
without the program.
"""
