"""Stream elements.  Importing this package registers every element
factory (≙ plugin registration)."""

from . import basic, decoder, filter, generator  # noqa: F401
