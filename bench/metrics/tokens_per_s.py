"""tokens_per_s (host clock): the prompt tokens prefilled and the tokens
generated by the window's batches, over the window's seconds: from the
first batch's call to the return of the last batch the window admitted
(it admits for ``--seconds``), so every batch in it is whole."""


def read(run):
    return run.work_in_window()[0] / run.window_s
