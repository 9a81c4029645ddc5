"""The learner: the train step (``step.py``), its host loop
(``learner.py``) and the fused on-device anakin loop (``anakin.py``)."""
