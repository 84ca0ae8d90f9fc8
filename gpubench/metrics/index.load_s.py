"""index.load_s: seconds of the program's ``KMerIndex.load`` of the
cell's index file in set-up (host clock), as ``infer`` loads it. The
upload to the card is left to the first sample, which builds the
program's ``Mapper`` as every ``quantify_files`` does."""


def read(run):
    return run.index_load_s
