"""Raw media schemas: what a media payload is and how it is laid out
(``caps``)."""

from .caps import MediaInfo, MediaSpec, parse_media_caps  # noqa: F401
