"""Mean host time of a dataplane edge (`dataplane.edge` program spans in
`constrain` and the explicit collectives: the record, the policy pass and
the mediation pipeline's launches), over the profiled slice."""

from cordbench import program_spans


def read(run):
    edges = program_spans.named(run, "dataplane.edge")
    if not edges:
        return None
    return sum(s.end_ns - s.start_ns for s in edges) / 1e3 / len(edges)
