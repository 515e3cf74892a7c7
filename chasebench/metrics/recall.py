"""recall: mean recall@K of the sampled queries of the window against the
reference's exact answer (the check's own number)."""


def read(ctx):
    return ctx.numbers.get("recall")
