r"""Two-layer quasi-geostrophic experiment: simulate, train, assimilate and
evaluate with the committed ``qg_0``/``qg_1``."""
