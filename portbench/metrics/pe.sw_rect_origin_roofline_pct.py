"""Percent of its roofline the rectangle DP with origins (csrc/
sw_rect.cu, entry `sw_rect_origin`, the fused PE path's) reaches over
the window, counted as se.sw_rect_roofline_pct counts the other entry."""


def read(ctx):
    return ctx.dp_roofline(origin=True)
