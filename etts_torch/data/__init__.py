"""Host-side input pipeline (port of ``etts/data``)."""
