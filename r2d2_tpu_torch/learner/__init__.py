"""The learner: the train step (``step.py``) and its host loop
(``learner.py``)."""
