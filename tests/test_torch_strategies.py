"""The port's search strategies draw from the JAX package's distributions.

The port draws from a ``torch.Generator`` where the JAX package draws
from ``jax.random``, so the two never give the same stream; what must
agree is what each stream is drawn from.

``torch_reference.strategy_draws`` takes ``DRAWS`` (8192) draws of every
random step — mutation, block crossover, tournament selection,
annealing's acceptance, one whole ES generation, and the uniform and
block-structured populations of the mapspace, co-search and topology
encodings — in both packages (the JAX package in a subprocess).  Each
gene's values (each block's, each index's, each acceptance's) are held
to the reference's by a chi-square test of homogeneity, and, where the
law is known in closed form, to that law by a goodness-of-fit test.  A
test fails when its smallest p-value, Bonferroni-corrected over the
columns it tests, is below ``ALPHA`` = 1e-3.  A mutation that never
draws a gene's top value, or a tournament that never draws the
population's last slot, fails here by many orders of magnitude.
Convergence over seeds is held to the reference's in
``tests/test_torch_convergence.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

import torch_reference as R  # noqa: E402

#: family-wise level of each distribution test (Bonferroni over columns)
ALPHA = 1e-3
#: the mutation rate ``strategy_draws`` mutates at
RATE = 0.15

reference = R.reference_fixture("""
    import jax
    import torch_reference as R
    OUT.update({"draws." + k: v for k, v in
                R.strategy_draws("repro", jax.random.PRNGKey).items()})
""")


@pytest.fixture(scope="module")
def port_draws():
    return R.strategy_draws("repro_torch", int)


@pytest.fixture(scope="module")
def draws(reference, port_draws):
    """name -> (port's draws, reference's draws)."""
    return {k: (v, reference["draws." + k]) for k, v in port_draws.items()}


def _counts(col, cats) -> np.ndarray:
    return np.array([(col == c).sum() for c in cats], float)


def _homogeneity(a, b) -> float:
    """p-value of a chi-square test that samples ``a`` and ``b`` come
    from one distribution over the values they take."""
    cats = np.union1d(np.unique(a), np.unique(b))
    if len(cats) < 2:
        return 1.0
    table = np.stack([_counts(a, cats), _counts(b, cats)])
    return stats.chi2_contingency(table, correction=False).pvalue


def _fit(col, probs) -> float:
    """p-value of a chi-square goodness-of-fit test of ``col`` (values
    0..len(probs)-1) against ``probs``."""
    probs = np.asarray(probs, float)
    keep = probs > 0
    obs = _counts(col, np.arange(len(probs)))
    assert obs[~keep].sum() == 0, "a value drawn with probability 0"
    if keep.sum() < 2:
        return 1.0
    exp = probs[keep] / probs[keep].sum() * len(col)
    return stats.chisquare(obs[keep], exp).pvalue


def _assert_all(pvalues, what) -> None:
    p = np.asarray(pvalues, float)
    assert p.min() * len(p) >= ALPHA, \
        f"{what}: p = {p.min():.3g} at column {int(p.argmin())} " \
        f"(Bonferroni over {len(p)})"


def _same_columns(a, b, what) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    _assert_all([_homogeneity(a[:, j], b[:, j])
                 for j in range(a.shape[1])], what)


def test_mutation_resamples_each_gene_as_the_reference(draws):
    """Each gene of a mutated genome keeps its value unless it flips
    (at ``RATE``, or as the row's one forced gene), and a flipped gene
    takes each of its ``cardinality`` values alike."""
    (got, want), card = draws["mutate"], draws["cardinality"][0]
    base = draws["base"][0]
    _same_columns(got, want, "mutate vs the reference")
    q = 1 - (1 - RATE) * (1 - 1 / len(card))
    for name, g in (("port", got), ("reference", want)):
        assert ((g >= 0) & (g < card)).all()
        law = [np.full(c, q / c) + (1 - q) * (np.arange(c) == b)
               for c, b in zip(card, base)]
        _assert_all([_fit(g[:, j], law[j]) for j in range(len(card))],
                    f"mutate ({name}) vs its law")


def test_crossover_takes_whole_blocks_evenly_as_the_reference(draws):
    """Each gene block comes whole from parent A or B, each w.p. 1/2,
    independently of the other blocks."""
    (got, want), card = draws["crossover"], draws["cardinality"][0]
    block, base = draws["gene_block"][0], draws["base"][0]
    live = card > 1                      # genes where the parents differ
    picks = {}
    for name, g in (("port", got), ("reference", want)):
        from_a = g == base
        blocks = sorted(set(block[live]))
        pick = np.stack([from_a[:, live & (block == b)].all(axis=1)
                         for b in blocks], axis=1)
        whole = np.stack([(~from_a[:, live & (block == b)]).all(axis=1)
                          for b in blocks], axis=1)
        assert (pick | whole).all(), f"{name}: a block was split"
        _assert_all([_fit(pick[:, j].astype(int), [0.5, 0.5])
                     for j in range(pick.shape[1])],
                    f"crossover ({name}) vs 1/2")
        # independence: the number of blocks taken from A is binomial
        n = pick.shape[1]
        law = stats.binom.pmf(np.arange(n + 1), n, 0.5)
        _assert_all([_fit(pick.sum(axis=1), law)],
                    f"crossover ({name}) blocks from A vs binomial")
        picks[name] = pick.astype(int)
    _same_columns(picks["port"], picks["reference"],
                  "crossover vs the reference")


def test_tournament_selection_as_the_reference(draws):
    """A 3-way tournament over 32 distinct fitness values picks the
    candidate of rank r (0 = fittest) w.p.
    ((32 - r) / 32)^3 - ((31 - r) / 32)^3."""
    got, want = draws["select"]
    n = len(R.SELECT_FITNESS)
    rank = np.argsort(np.argsort(R.SELECT_FITNESS))
    r = np.arange(n)
    law_by_rank = ((n - r) / n) ** 3 - ((n - r - 1) / n) ** 3
    law = law_by_rank[rank]               # by candidate index
    _assert_all([_homogeneity(got, want), _fit(got, law),
                 _fit(want, law)], "tournament selection")


def test_annealing_accepts_as_the_reference(draws):
    """At generation 1 (temperature 0.46) a proposal whose log-fitness
    is ``delta`` worse is accepted w.p. exp(-delta / 0.46)."""
    got, want = draws["accept"]
    delta = np.resize(R.ANNEAL_DELTAS, len(got))
    temp = 0.5 * 0.92
    pvals = []
    for d in R.ANNEAL_DELTAS:
        sel = delta == d
        a = np.exp(-d / temp)
        pvals += [_homogeneity(got[sel].astype(int), want[sel].astype(int)),
                  _fit(got[sel].astype(int), [1 - a, a]),
                  _fit(want[sel].astype(int), [1 - a, a])]
    _assert_all(pvals, "annealing acceptance")


def test_es_generation_as_the_reference(draws):
    """One ES generation (selection, crossover at 0.6, mutation, a
    quarter immigrants): the children and the immigrants, gene by
    gene."""
    got, want = draws["es_children"]
    n_imm = int(round(0.25 * len(got)))
    _same_columns(got[:-n_imm], want[:-n_imm], "ES children")
    _same_columns(got[-n_imm:], want[-n_imm:], "ES immigrants")


@pytest.mark.parametrize("enc", ["conv2_x", "cosearch", "topology_design"])
def test_uniform_population_as_the_reference(draws, enc):
    """Every gene uniform over its cardinality."""
    (got, want), card = draws[f"{enc}.random"], draws[f"{enc}.cardinality"][0]
    _same_columns(got, want, f"{enc} random population")
    for name, g in (("port", got), ("reference", want)):
        _assert_all([_fit(g[:, j], np.full(c, 1 / c))
                     for j, c in enumerate(card)],
                    f"{enc} random population ({name}) vs uniform")


@pytest.mark.parametrize("enc", ["conv2_x", "cosearch", "topology_design"])
def test_structured_population_as_the_reference(draws, enc):
    """Block-structured genomes: every gene, and every rank block's
    genes jointly (two levels and a cut), as the reference draws
    them."""
    got, want = draws[f"{enc}.structured"]
    _same_columns(got, want, f"{enc} structured population")
    if enc == "conv2_x":
        block = draws["gene_block"][0]
        joint = []
        base = int(max(got.max(), want.max())) + 1
        for b in sorted(set(block)):
            cols = block == b
            digits = base ** np.arange(cols.sum())
            joint.append(_homogeneity(got[:, cols] @ digits,
                                      want[:, cols] @ digits))
        _assert_all(joint, f"{enc} structured blocks jointly")


def test_initial_population_as_the_reference(draws):
    """Half block-structured, half uniform."""
    got, want = draws["init"]
    half = len(got) // 2
    _same_columns(got[:len(got) - half], want[:len(got) - half],
                  "initial population, structured half")
    _same_columns(got[len(got) - half:], want[len(got) - half:],
                  "initial population, uniform half")
