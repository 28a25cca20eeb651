"""Functional layers over parameter dicts (weights in ``(d_in, d_out)``)."""
