"""Share of the MoE layer's expert-weight spans whose leaf arrived held in
the compute dtype, so that no cast ran: the `moe.cast` program spans with
`held` true over all of them, in %.  None where the spans carry no `held`
(a program that does not record it)."""

from cordbench import program_spans


def read(run):
    held = [s.attrs.get("held") for s in program_spans.named(run, "moe.cast")]
    if not held or any(h is None for h in held):
        return None
    return 100.0 * sum(map(bool, held)) / len(held)
