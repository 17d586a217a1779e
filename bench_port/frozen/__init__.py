"""Frozen copies of the port's input generator, kept here so that the
benchmark's inputs do not move when the program does.

``sim`` is ``rpvg_tpu_torch/sim.py`` as it stood when the benchmark was
written, less what the generator does not use (the path index it built
beside the panel, the isolated-transcript panel, single-end reads);
``alignments``, ``constants`` and ``scoring`` are the modules of the
same name that it and the writer read.  ``rpa`` holds the ``.rpa``
writer and the fragment serialization it writes, copied from
``rpvg_tpu_torch/io/rpa.py`` and ``rpvg_tpu_torch/native.py``.

Only the generator (:mod:`bench_port.inputs`) uses them: the plain
reference (:mod:`bench_port.reference`) shares no code with the port."""
