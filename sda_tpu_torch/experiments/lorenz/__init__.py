r"""Lorenz experiment: simulate the data, train the scores, measure log p."""
