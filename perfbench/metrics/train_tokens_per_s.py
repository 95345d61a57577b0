"""train_tokens_per_s: the tokens of every whole step run in the window,
over the time from the window's start to the last step's synchronised
end.  Host clock."""


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    return rec["steps"] * rec["tokens_per_step"] / rec["window_s"]
