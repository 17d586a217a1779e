"""The plain reference: the same semantics as the port, worked out again
from the generated inputs (graph and panel JSON, info TSV, the ``.rpa``
reads) in plain Python and NumPy, from rpvg's own description of them.
It imports nothing of the port, shares no code with it and takes nothing
the port made: the fragment pass places each read pair on the panel's
paths (:mod:`bench_port.reference.fragment_pass`), the probabilities and
the inference follow (:mod:`bench_port.reference.probabilities`,
:mod:`bench_port.reference.haplotype_transcripts`), and
:mod:`bench_port.reference.compare` reads the port's estimate files only
to judge them.  A configuration names its reference module by the key
``reference`` of its file."""
