"""The synthetic LM data pipeline (numpy; shared arithmetic with the JAX
package's ``data/``)."""
from .pipeline import DataState, SyntheticLM, make_pipeline

__all__ = ["DataState", "SyntheticLM", "make_pipeline"]
