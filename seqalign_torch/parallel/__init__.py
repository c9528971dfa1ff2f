"""Many-pair alignment: ``BatchAligner`` on one device."""

from .batch import BatchAligner

__all__ = ["BatchAligner"]
