"""Command-line tools of the port: ``launch`` (the ``gst-launch``
counterpart).  ``confchk``, ``inspect``, ``pbtxt``, ``codegen`` and
``convert`` wait for ROADMAP A12.2."""
