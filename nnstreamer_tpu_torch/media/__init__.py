"""Raw media entering the tensor world: what a media payload is and how it
is laid out (``caps``), and the container readers and writers the file
sources use (``y4m``, ``wav``, ``image``) in place of ``filesrc !
decodebin ! videoconvert``."""

from .caps import MediaInfo, MediaSpec, parse_media_caps  # noqa: F401
