"""The benchmark's plain reference (``model.py``) and the frozen copies of
the parser, fold, ops and training functions it is built from.  Imports
nothing of the program under test."""
