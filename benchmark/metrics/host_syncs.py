"""Host syncs (calls that made the host wait for the card, by torch's sync
debug mode) of one unit of the cell's work: a sequence, a step, or a
frame (the mean over one whole sequence of a stream).  A count that
repeats exactly."""


def read(ctx):
    return ctx.layer.get("host_syncs")
