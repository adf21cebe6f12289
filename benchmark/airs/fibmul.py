"""The two-column multiplicative Fibonacci AIR (the program's FibMul):
a_{i+1} = b_i, b_{i+1} = a_i b_i, from a_0 = 1 and the witness b_0;
publics a_0, b_0 and the last b."""

COLUMNS = 2
SHIFTS = (0, 1)  # rows a query opens, from its index
ALPHAS = 5  # composition weights drawn
PROGRAM_AIR = ("FibMulAIR", "b0")  # class, witness keyword


def plain_trace(p: int, witness: int, rows: int) -> list[list[int]]:
    a_col, b_col, a, b = [], [], 1, witness % p
    for _ in range(rows):
        a_col.append(a)
        b_col.append(b)
        a, b = b, a * b % p
    return [a_col, b_col]


def publics(at) -> dict:
    """`at(column, row)` reads the trace."""
    return {"input": at(0, 0), "output": at(1, -1), "b0": at(1, 0)}


def terms(ctx) -> list:
    """The constraints, each divided by its vanishing polynomial, on the
    coset (``reference.stark.Composition``)."""
    f, c, pub = ctx.f, ctx.c, ctx.publics
    ax, bx = ctx.ldes
    agx, bgx = ctx.shifted(0, 1), ctx.shifted(1, 1)
    tm = ctx.transition(1)
    return [
        f.mul(f.sub(ax, c(pub["input"])), ctx.inv_first),
        f.mul(f.sub(bx, c(pub["b0"])), ctx.inv_first),
        f.mul(f.sub(bx, c(pub["output"])), ctx.inv_last),
        f.mul(f.sub(agx, bx), tm),
        f.mul(f.sub(bgx, f.mul(ax, bx)), tm)]
