"""The plain reference: the same STARK in plain torch and the standard
library, sharing nothing with the program under test (``stark.py``,
over ``field.py`` and ``sha256.py``)."""
